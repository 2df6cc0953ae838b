"""FAST5 (single-read HDF5) reads and writes (copy of
``tombo_tpu/io/fast5.py``), in the reference's on-disk layout
(reference: tombo/tombo_helper.py:2090-2460): raw signal under
``/Raw/Reads/Read_*/Signal``, basecalls under
``/Analyses/<bc_grp>/<subgrp>/Fastq``, re-squiggle results under
``/Analyses/<corrected_group>/<subgroup>/`` with the same datasets and
attributes, so each package reads the other's files.

``h5py`` is imported inside the functions that open a file, so the card
path, which reads no FAST5, runs without it."""
from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .._version import VERSION
from ..errors import TomboError
from ..ops import ref_impl
from ..seq import get_mean_q_score, rev_transcribe
from ..types import ChannelInfo, ResquiggleResults, SequenceData


def get_raw_read_slot(fast5_data):
    """The raw-signal group (reference: tombo/tombo_helper.py:2072-2092)."""
    try:
        return next(iter(fast5_data["/Raw/Reads"].values()))
    except (KeyError, StopIteration):
        raise TomboError("Raw data is not found in /Raw/Reads/Read_[read#]")


def get_raw_signal(fast5_data) -> np.ndarray:
    try:
        return get_raw_read_slot(fast5_data)["Signal"][:]
    except (OSError, KeyError):
        raise TomboError("Cannot read raw signal data")


def get_read_id(fast5_data) -> str:
    """The read id of an open FAST5 file, from its raw-signal group."""
    slot = get_raw_read_slot(fast5_data)
    rid = slot.attrs.get("read_id")
    if rid is None:
        rid = slot.attrs.get("read_num", "unknown")
    if isinstance(rid, bytes):
        rid = rid.decode()
    return str(rid)


def get_channel_info(fast5_data) -> ChannelInfo:
    """Reference: tombo/tombo_helper.py ``get_channel_info``."""
    try:
        attrs = fast5_data["UniqueGlobalKey/channel_id"].attrs
    except KeyError:
        raise TomboError("No channel_id group in FAST5")
    return ChannelInfo(
        offset=float(attrs["offset"]), range=float(attrs["range"]),
        digitisation=float(attrs["digitisation"]),
        number=int(attrs.get("channel_number", 0)),
        sampling_rate=int(attrs.get("sampling_rate", 4000)))


def _attr_str(v):
    return v.decode() if isinstance(v, bytes) else v


def is_read_rna(fast5_data) -> bool:
    """RNA from the basecall group's attributes or the experiment type
    (reference: tombo/tombo_helper.py:872-935 ``is_read_rna``)."""
    try:
        bc_grp = fast5_data["/Analyses/Basecall_1D_000"]
    except KeyError:
        return False
    for key in ("name", "model_type"):
        v = _attr_str(bc_grp.attrs.get(key))
        if v is not None and "rna" in str(v).lower():
            return True
    try:
        exp_type = _attr_str(fast5_data["UniqueGlobalKey/context_tags"]
                             .attrs.get("experiment_type"))
        if exp_type is not None and "rna" in str(exp_type).lower():
            return True
    except KeyError:
        pass
    return False


def get_read_seq(fast5_data, bc_grp: str = "Basecall_1D_000",
                 bc_subgrp: str = "BaseCalled_template",
                 is_rna: bool = False,
                 q_score_thresh: float = 0) -> SequenceData:
    """The basecalled sequence of the Fastq slot (reference:
    tombo/resquiggle.py:1221-1276 ``get_read_seq``)."""
    try:
        fastq_raw = fast5_data[
            "/Analyses/" + bc_grp + "/" + bc_subgrp + "/Fastq"][()]
    except KeyError:
        raise TomboError("Fastq slot not present in --basecall-group")
    if isinstance(fastq_raw, bytes):
        fastq_raw = fastq_raw.decode()
    s_fastq = fastq_raw.split("\n")
    read_seq, read_q = s_fastq[1], s_fastq[3]
    mean_q_score = get_mean_q_score(read_q)
    if q_score_thresh is not None and mean_q_score < q_score_thresh:
        raise TomboError("Read filtered by q-score.")
    read_id = get_read_id(fast5_data)
    if is_rna:
        read_seq = rev_transcribe(read_seq)
    return SequenceData(seq=read_seq, id=read_id, mean_q_score=mean_q_score)


def prep_fast5(fast5_fn: str, corr_grp: str, overwrite: bool,
               bc_grp: Optional[str] = None):
    """Delete any previous corrected group and create a fresh one
    (reference: tombo/tombo_helper.py:2259-2324 ``prep_fast5``).  Raises
    TomboError on failure."""
    import h5py
    if not os.access(fast5_fn, os.W_OK):
        raise TomboError("FAST5 file is not writable")
    try:
        fast5_data = h5py.File(fast5_fn, "r+")
    except Exception:
        raise TomboError("Error opening or writing to fast5 file")
    with fast5_data:
        try:
            analyses_grp = fast5_data["/Analyses"]
        except KeyError:
            raise TomboError(
                "Base calls not found in FAST5 (see `preprocess`)")
        if bc_grp is not None and bc_grp not in analyses_grp:
            raise TomboError(
                "Base calls not found in FAST5 (see `preprocess`)")
        if corr_grp in analyses_grp:
            if not overwrite:
                raise TomboError(
                    "Tombo data exists in [--corrected-group] and "
                    "[--overwrite] is not set")
            del analyses_grp[corr_grp]
        new_grp = analyses_grp.create_group(corr_grp)
        new_grp.attrs["tombo_version"] = VERSION
        new_grp.attrs["basecall_group"] = bc_grp if bc_grp else ""


def write_error_status(fn: str, corr_grp: str, bc_subgrp: Optional[str],
                       error_text: str):
    """Record a read's failure in its corrected group (reference:
    tombo/tombo_helper.py:2326-2338)."""
    import h5py
    with h5py.File(fn, "r+") as fast5_data:
        grp = fast5_data["/Analyses"][corr_grp]
        if bc_subgrp is not None:
            grp = grp.create_group(bc_subgrp)
        grp.attrs["status"] = error_text


def write_new_fast5_group(fast5_fn_or_fp, corr_grp_slot: str,
                          rsqgl_res: ResquiggleResults, norm_type: str,
                          compute_sd: bool, rna: bool = False,
                          resolved_params: Optional[str] = None
                          ) -> np.ndarray:
    """Write one re-squiggle result into the FAST5 (a file name or an open
    file; reference: tombo/tombo_helper.py:2341-2460
    ``write_new_fast5_group``): the ``Events`` dataset (norm_mean,
    norm_stdev, start, length, base), the ``Alignment`` attributes and
    the scaling attributes, and ``resolved_params``, the JSON of the run's
    resolved parameters.  A file given by name is closed before this
    returns.  Returns the per-base normalized means."""
    if compute_sd:
        norm_means, norm_stds = ref_impl.new_mean_stds(
            rsqgl_res.raw_signal, rsqgl_res.segs)
    else:
        norm_means = ref_impl.new_means(rsqgl_res.raw_signal, rsqgl_res.segs)
        norm_stds = np.full(norm_means.shape[0], np.nan)

    event_data = np.empty(norm_means.shape[0], dtype=[
        ("norm_mean", "f8"), ("norm_stdev", "f8"),
        ("start", "u4"), ("length", "u4"), ("base", "S1")])
    event_data["norm_mean"] = norm_means
    event_data["norm_stdev"] = norm_stds
    event_data["start"] = rsqgl_res.segs[:-1]
    event_data["length"] = np.diff(rsqgl_res.segs)
    event_data["base"] = np.frombuffer(
        rsqgl_res.genome_seq.encode("ascii"), dtype="S1")

    if isinstance(fast5_fn_or_fp, (str, os.PathLike)):
        import h5py
        with h5py.File(fast5_fn_or_fp, "r+") as fast5_data:
            _write_group(fast5_data, corr_grp_slot, rsqgl_res, norm_type,
                         rna, resolved_params, event_data)
    else:
        _write_group(fast5_fn_or_fp, corr_grp_slot, rsqgl_res, norm_type,
                     rna, resolved_params, event_data)
    return norm_means


def _write_group(fast5_data, corr_grp_slot, rsqgl_res, norm_type, rna,
                 resolved_params, event_data):
    corr_grp = fast5_data["/Analyses"][corr_grp_slot]
    corr_subgrp = corr_grp.create_group(rsqgl_res.align_info.subgroup)
    corr_subgrp.attrs["status"] = "success"
    corr_subgrp.attrs["rna"] = rna
    if resolved_params is not None:
        corr_subgrp.attrs["resolved_params"] = resolved_params
    if rsqgl_res.sig_match_score is not None:
        corr_subgrp.attrs["signal_match_score"] = rsqgl_res.sig_match_score
    sv = rsqgl_res.scale_values
    corr_subgrp.attrs["shift"] = sv.shift
    corr_subgrp.attrs["scale"] = sv.scale
    corr_subgrp.attrs["norm_type"] = norm_type
    if sv.lower_lim is not None and not np.isnan(sv.lower_lim):
        corr_subgrp.attrs["lower_lim"] = sv.lower_lim
    if sv.upper_lim is not None and not np.isnan(sv.upper_lim):
        corr_subgrp.attrs["upper_lim"] = sv.upper_lim
    if sv.outlier_thresh is not None:
        corr_subgrp.attrs["outlier_threshold"] = sv.outlier_thresh

    corr_alignment = corr_subgrp.create_group("Alignment")
    corr_alignment.attrs["mapped_start"] = rsqgl_res.genome_loc.start
    corr_alignment.attrs["mapped_end"] = (
        rsqgl_res.genome_loc.start + len(rsqgl_res.segs) - 1)
    corr_alignment.attrs["mapped_strand"] = rsqgl_res.genome_loc.strand
    corr_alignment.attrs["mapped_chrom"] = rsqgl_res.genome_loc.chrom
    ai = rsqgl_res.align_info
    if ai is not None:
        corr_alignment.attrs["clipped_bases_start"] = ai.clip_start
        corr_alignment.attrs["clipped_bases_end"] = ai.clip_end
        corr_alignment.attrs["num_insertions"] = ai.insertions
        corr_alignment.attrs["num_deletions"] = ai.deletions
        corr_alignment.attrs["num_matches"] = ai.matches
        corr_alignment.attrs["num_mismatches"] = ai.mismatches

    corr_events = corr_subgrp.create_dataset(
        "Events", data=event_data, compression="gzip")
    corr_events.attrs["read_start_rel_to_raw"] = \
        rsqgl_res.read_start_rel_to_raw


def get_single_slot_read_centric(fast5_fn_or_fp, slot_name: str,
                                 corr_grp: str) -> Tuple[np.ndarray, bool]:
    """One ``Events`` column, read-centric, and the RNA flag (reference:
    tombo/tombo_helper.py:1593-1659)."""
    def read(fast5_data):
        data = fast5_data["/Analyses/" + corr_grp + "/Events"][slot_name][:]
        rev_sig = fast5_data["/Analyses/" + corr_grp].attrs.get("rna", False)
        return data, bool(rev_sig)

    if isinstance(fast5_fn_or_fp, (str, os.PathLike)):
        import h5py
        with h5py.File(fast5_fn_or_fp, "r") as fast5_data:
            return read(fast5_data)
    return read(fast5_fn_or_fp)


def read_corrected_levels(fn: str, corr_group: str,
                          read_id: Optional[str] = None
                          ) -> Tuple[np.ndarray, str, str]:
    """(norm_mean per base, base sequence, read id) of one read's
    corrected group, read-centric (reference: tombo/tombo_helper.py:
    1593-1659).  ``read_id``, when the index carries it, saves the walk of
    /Raw/Reads."""
    import h5py
    with h5py.File(fn, "r") as fp:
        events = fp["/Analyses/" + corr_group]["Events"][:]
        means = events["norm_mean"]
        seq = b"".join(events["base"]).decode()
        if read_id is None:
            try:
                read_id = get_read_id(fp)
            except TomboError:
                read_id = "unknown"
    return means, seq, read_id


def read_corrected_events(fast5_fn: str, corr_grp: str):
    """(Events table, read_start_rel_to_raw, Alignment attributes, RNA
    flag) of a re-squiggled read's corrected group."""
    import h5py
    with h5py.File(fast5_fn, "r") as fast5_data:
        grp = fast5_data["/Analyses/" + corr_grp]
        events = grp["Events"][:]
        rsrtr = int(grp["Events"].attrs["read_start_rel_to_raw"])
        align_attrs = dict(grp["Alignment"].attrs.items())
        rna = bool(grp.attrs.get("rna", False))
    return events, rsrtr, align_attrs, rna


def read_raw_and_events(fn: str, corr_group: str
                        ) -> Tuple[np.ndarray, np.ndarray, str]:
    """(stored raw signal, event starts, base sequence) of one read's
    corrected group (reference: tombo/tombo_stats.py:1618-1624)."""
    import h5py
    with h5py.File(fn, "r") as fp:
        try:
            raw = next(iter(fp["/Raw/Reads"].values()))["Signal"][:]
        except (KeyError, StopIteration):
            raise TomboError("Cannot read raw signal data")
        events = fp["/Analyses/" + corr_group + "/Events"]
        starts = events["start"][:].astype(np.int64)
        seq = b"".join(events["base"][:]).decode()
    return raw, starts, seq


def iter_fast5_reads(fast5s_dir: str) -> Iterator[str]:
    """Every .fast5 file under a directory tree, sorted within each
    directory."""
    for root, _, fns in os.walk(fast5s_dir):
        for fn in sorted(fns):
            if fn.endswith(".fast5"):
                yield os.path.join(root, fn)


# ----------------------------------------------------------- lock files
def get_lock_fn(fast5s_dir: str) -> str:
    """Reference: tombo/tombo_helper.py:972-987."""
    if fast5s_dir.endswith("/"):
        fast5s_dir = fast5s_dir[:-1]
    head, tail = os.path.split(fast5s_dir)
    return os.path.join(head, "." + tail + ".tombo.lock")


def lock_dirs(fast5s_dirs: List[str], ignore_locks: bool = False
              ) -> List[str]:
    """A lock file beside every directory of the trees, so two
    re-squiggle runs never write the same reads."""
    lock_fns = []
    for d in fast5s_dirs:
        for root, _, _ in os.walk(d):
            lock_fn = get_lock_fn(root)
            if not ignore_locks and os.path.exists(lock_fn):
                clear_locks(lock_fns)
                raise TomboError(
                    "This set of reads is currently being processed by "
                    "another resquiggle command (or a previous run exited "
                    "unexpectedly). Use --ignore-read-locks to override.")
            open(lock_fn, "w").close()
            lock_fns.append(lock_fn)
    return lock_fns


def clear_locks(lock_fns: List[str]):
    for fn in lock_fns:
        try:
            if os.path.exists(fn):
                os.remove(fn)
        except OSError:
            pass


# ------------------------------------------------------------- basecalls

def write_fastq(fast5_fn: str, record: str, bc_grp: str, bc_subgrp: str,
                overwrite: bool) -> bool:
    """Store a FASTQ record as ``/Analyses/<bc_grp>/<bc_subgrp>/Fastq``
    (a variable-length string, as basecallers write it; reference:
    tombo/_preprocess.py:253-290).  False, and the file unchanged, where
    the slot exists and ``overwrite`` is off."""
    import h5py
    slot = "/Analyses/" + bc_grp + "/" + bc_subgrp
    with h5py.File(fast5_fn, "r+") as fp:
        if slot + "/Fastq" in fp:
            if not overwrite:
                return False
            del fp[slot + "/Fastq"]
        fp.require_group(slot).create_dataset(
            "Fastq", data=record, dtype=h5py.special_dtype(vlen=str))
    return True
