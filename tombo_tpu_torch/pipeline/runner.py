"""Re-squiggle orchestration: reads in, corrected groups, index and levels
sidecar out (counterpart of ``tombo_tpu/pipeline/runner.py``).

The reference fans the whole re-squiggle out over N processes x M
threads (reference: tombo/resquiggle.py:1859-1948
``resquiggle_all_reads``).  Here host threads (or, for large FAST5 runs,
spawned ingest processes, ``pipeline/ingest.py``) read and map the reads,
a look-ahead window sorts them by signal length into batches, the
batches go through :class:`BatchedResquiggler` on the card, and the
results are written back on the host, inline or by writer processes
sharded by file.  Every per-read failure is recorded (FAST5 status
attribute, failed-reads file) and the run goes on (reference failure
taxonomy, tombo/resquiggle.py:1704-1806).

The reads come from a read source: :class:`Fast5Reads` (every FAST5 file
under a directory, the default) or :class:`MemoryReads` (names, raw
signals and basecalls held in memory).  Both go through the same
mapping, window, batching, failure taxonomy and index building; a
memory source writes nothing (dry-run semantics for the FAST5 and status
writes), so its index stays in memory.
"""
from __future__ import annotations

import os
import time
import zlib
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from .. import config
from ..device import DeviceLike
from ..errors import TomboError
from ..io import fast5 as f5io
from ..io.index import ReadsIndex
from ..io.model_io import KmerModel
from ..seq import invalid_seq
from ..stats import levels_cache as lc
from ..types import ReadData, ResquiggleResults, SeqSampleType, SequenceData
from . import resquiggle as rsq
from .batch import BatchedResquiggler

POOR_MATCH = ("Poor raw to expected signal matching "
              "(revert with `filter clear_filters`)")


@dataclass
class RunConfig:
    corrected_group: str = config.DEFAULT_CORRECTED_GROUP
    basecall_group: str = config.DEFAULT_BASECALL_GROUP
    basecall_subgroups: Tuple[str, ...] = (
        config.DEFAULT_BASECALL_SUBGROUP,)
    overwrite: bool = False
    ignore_read_locks: bool = False
    q_score_thresh: float = 0.0
    signal_length_range: Optional[Tuple[int, int]] = None
    sequence_length_range: Optional[Tuple[int, int]] = None
    sig_match_thresh: Optional[float] = None
    obs_filter: Optional[List[Tuple[float, float]]] = None
    batch_size: int = 64
    num_io_threads: int = 8
    progress: bool = False
    skip_index: bool = False
    compute_sd: bool = False
    dry_run: bool = False
    max_scaling_iters: int = config.MAX_SCALING_ITERS
    outlier_thresh: Optional[float] = config.OUTLIER_THRESH
    # the card (None: "cuda"), the dtype (None: float32; float64 on the
    # CPU only) and a reads mesh, for the BatchedResquiggler the run
    # makes; with a mesh, batch_size is per device
    device: DeviceLike = None
    dtype: Optional[object] = None
    mesh: Optional[object] = None
    # a parallel.distributed.DistContext: this host takes only its hash
    # shard of the files and writes the index shard ``.host<i>``
    dist: Optional[object] = None
    # --fixed-scale / --fit-global-scale (reference:
    # tombo/_option_parsers.py:457-464, tombo/tombo_stats.py:452-476)
    const_scale: Optional[float] = None
    fit_global_scale: bool = False
    # --skip-sequence-rescaling (reference: tombo/_option_parsers.py:465)
    skip_seq_rescaling: bool = False
    # --failed-reads-filename / --num-most-common-errors (reference:
    # tombo/_option_parsers.py:83-85,371-374)
    failed_reads_fn: Optional[str] = None
    num_most_common_errors: int = 0
    # FAST5 writer processes, sharded by file; None: 3 when the run has
    # 256 units or more, else inline writes
    num_write_procs: Optional[int] = None
    # the spawned ingest pool serves FAST5 runs of ingest_min units or
    # more, with ingest_procs processes (None: 2 to 6 by the CPU count);
    # smaller runs and memory sources map on num_io_threads threads
    ingest_min: int = 256
    ingest_procs: Optional[int] = None
    # print where the run's host time went
    profile: bool = False
    # append each written read to its directory's levels sidecar
    levels_sidecar: bool = True


@dataclass
class RunSummary:
    n_success: int = 0
    n_failed: int = 0
    failure_modes: Counter = field(default_factory=Counter)
    # seconds: mapping (summed over the mapping threads or processes'
    # chunks as they arrive), the batch loop (re-squiggle on the device,
    # less the wait for mapped reads), writeback, and the whole run
    timings: Dict[str, float] = field(default_factory=dict)

    def as_dict(self):
        return dict(n_success=self.n_success, n_failed=self.n_failed,
                    failure_modes=dict(self.failure_modes))


# --------------------------------------------------------------------------
# read sources

class Fast5Reads:
    """Every FAST5 file under ``fast5s_dir`` (the default source)."""

    writes = True

    def __init__(self, fast5s_dir: Optional[str] = None):
        self.fast5s_dir = fast5s_dir

    def names(self) -> List[str]:
        return list(f5io.iter_fast5_reads(self.fast5s_dir))

    @staticmethod
    def prep(fn: str, rc: RunConfig):
        f5io.prep_fast5(fn, rc.corrected_group, rc.overwrite,
                        rc.basecall_group)

    @staticmethod
    def raw(fn: str) -> np.ndarray:
        import h5py
        with h5py.File(fn, "r") as fp:
            return f5io.get_raw_signal(fp)

    @staticmethod
    def read(fn: str, rc: RunConfig, is_rna: bool):
        """(raw signal, per basecall subgroup its SequenceData or the
        exception reading it raised)."""
        import h5py
        seqs = []
        with h5py.File(fn, "r") as fp:
            raw = f5io.get_raw_signal(fp)
            for subgrp in rc.basecall_subgroups:
                try:
                    seqs.append(f5io.get_read_seq(
                        fp, rc.basecall_group, subgrp, is_rna,
                        rc.q_score_thresh))
                except Exception as e:  # noqa: BLE001 — the unit's error
                    seqs.append(e)
        return raw, seqs


class MemoryReads:
    """Reads held in memory: (name, raw signal as stored, basecalls as
    SequenceData) each, the one basecall serving every subgroup.  A run
    over it writes nothing: no FAST5, status, index or sidecar file."""

    writes = False

    def __init__(self, reads: Iterable[Tuple[str, np.ndarray,
                                             SequenceData]]):
        self._reads = {name: (raw, seq) for name, raw, seq in reads}

    def names(self) -> List[str]:
        return list(self._reads)

    def raw(self, fn: str) -> np.ndarray:
        return self._reads[fn][0]

    def read(self, fn: str, rc: RunConfig, is_rna: bool):
        raw, seq = self._reads[fn]
        if rc.q_score_thresh is not None and \
                seq.mean_q_score < rc.q_score_thresh:
            seq = TomboError("Read filtered by q-score.")
        return raw, [seq] * len(rc.basecall_subgroups)


def _unexpected(e: Exception) -> str:
    return "Unexpected error: " + repr(e)


def load_and_map(fn: str, source, aligner, std_ref: KmerModel,
                 seq_samp_type: SeqSampleType, rc: RunConfig,
                 rsqgl_params) -> List[tuple]:
    """Host I/O and mapping of one file: (fn, subgroup, mapped read or
    None, error or None) per basecall subgroup (reference:
    tombo/resquiggle.py:1385-1481 ``_io_and_map_read``).  A failed prep
    is one unit of the first subgroup; a failed read of the raw signal,
    or a signal outside ``signal_length_range``, fails every subgroup."""
    sgs = rc.basecall_subgroups
    if source.writes and not rc.dry_run:
        try:
            source.prep(fn, rc)
        except TomboError as e:
            return [(fn, sgs[0], None, str(e))]
        except Exception as e:  # noqa: BLE001 — recorded, run goes on
            return [(fn, sgs[0], None, _unexpected(e))]
    try:
        raw, seqs = source.read(
            fn, rc, seq_samp_type.name == config.RNA_SAMP_TYPE)
    except TomboError as e:
        return [(fn, sg, None, str(e)) for sg in sgs]
    except Exception as e:  # noqa: BLE001
        return [(fn, sg, None, _unexpected(e)) for sg in sgs]
    if not (rc.signal_length_range is None or
            rc.signal_length_range[0] < raw.shape[0] <
            rc.signal_length_range[1]):
        return [(fn, sg, None, "Raw signal not within --signal-length-range")
                for sg in sgs]
    units = []
    for subgrp, seq_data in zip(sgs, seqs):
        try:
            if isinstance(seq_data, Exception):
                raise seq_data
            mr = rsq.map_read(seq_data, aligner, std_ref, seq_samp_type,
                              subgrp, rc.sequence_length_range)
            if invalid_seq(mr.genome_seq):
                raise TomboError(
                    "Reference mapping contains non-canonical bases")
            mr = mr.replace(raw_signal=raw.astype(np.float64))
            units.append((fn, subgrp, rsq.adjust_map_res(
                mr, seq_samp_type, rsqgl_params), None))
        except TomboError as e:
            units.append((fn, subgrp, None, str(e)))
        except Exception as e:  # noqa: BLE001
            units.append((fn, subgrp, None, _unexpected(e)))
    return units


# --------------------------------------------------------------------------
# FAST5 writeback: inline, or by writer processes sharded by file CRC so
# no two processes open one file (reference analog: the writer processes
# of tombo/resquiggle.py:1828).  Each written read is appended to its
# directory's levels sidecar, one shard a writer (``.w<i>``, ``.wm``
# inline), with the file's (mtime_ns, size) taken after it is closed.

class _Sidecars:
    """One sidecar builder a (directory, corrected group) for one
    writer."""

    def __init__(self, shard_tag: str):
        self.shard_tag = shard_tag
        self.builders: Dict[tuple, Optional[lc.LevelsCacheBuilder]] = {}

    def add(self, fn: str, res: ResquiggleResults, corr_grp: str,
            norm_means: np.ndarray):
        group = corr_grp + "/" + res.align_info.subgroup
        dirpath = os.path.dirname(fn) or "."
        key = (dirpath, group)
        if key not in self.builders:
            try:
                self.builders[key] = lc.LevelsCacheBuilder(
                    lc.cache_fn(dirpath, group) + ".w" + self.shard_tag)
            except OSError:             # an unwritable directory: no cache
                self.builders[key] = None
        b = self.builders[key]
        if b is not None:
            st = os.stat(fn)
            b.add(fn, group, res.align_info.read_id, st.st_mtime_ns,
                  st.st_size, norm_means, res.genome_seq, replace=True)

    def flush(self):
        for b in self.builders.values():
            if b is not None:
                b.flush()

    def close(self):
        for b in self.builders.values():
            if b is not None:
                b.finalize()
        self.builders.clear()


def _write_one(fn, res, corr_grp, compute_sd, rna, resolved, sidecars):
    norm_means = f5io.write_new_fast5_group(
        fn, corr_grp, res, "median", compute_sd, rna=rna,
        resolved_params=resolved)
    if sidecars is not None:
        sidecars.add(fn, res, corr_grp, norm_means)


def _writer_proc_main(q, ack_q, shard_tag):
    """A writer process: write each job's group; at a flush barrier,
    flush the sidecars and answer with the token and the (file,
    subgroup) of every write that failed since the last barrier, on the
    same queue, so the answer cannot overtake a failure.  Started by
    ``ingest.start_hidden``: it sees no card."""
    sidecars = _Sidecars(shard_tag)
    failed = []
    while True:
        job = q.get()
        if job is None:
            break
        if job[0] == 1:
            sidecars.flush()
            ack_q.put((job[1], failed))
            failed = []
            continue
        _, fn, res, cg, csd, rna, rp, sidecar = job
        try:
            _write_one(fn, res, cg, csd, rna, rp,
                       sidecars if sidecar else None)
        except Exception:  # noqa: BLE001 — answered at the barrier
            failed.append((fn, res.align_info.subgroup))
    sidecars.close()


class _ShardedWriters:
    def __init__(self, n: int):
        import multiprocessing as mp
        from .ingest import start_hidden
        ctx = mp.get_context("spawn")     # no fork of a process with CUDA
        self.qs = [ctx.Queue(maxsize=512) for _ in range(n)]
        self.ack_q = ctx.Queue()
        self.procs = [
            ctx.Process(target=_writer_proc_main,
                        args=(qq, self.ack_q, str(i)), daemon=True)
            for i, qq in enumerate(self.qs)]
        start_hidden(self.procs)
        self._token = 0

    def alive(self) -> bool:
        return all(p.is_alive() for p in self.procs)

    def submit(self, fn: str, res, corrected_group: str, compute_sd: bool,
               rna: bool, resolved_params, sidecar: bool):
        shard = zlib.crc32(fn.encode()) % len(self.qs)
        self.qs[shard].put((0, fn, res, corrected_group, compute_sd, rna,
                            resolved_params, sidecar))

    def flush(self) -> List[Tuple[str, str]]:
        """Barrier: returns once every writer has written (and closed)
        every file submitted before it, with the (fn, subgroup) of each
        failed write."""
        self._token += 1
        for qq in self.qs:
            qq.put((1, self._token))
        seen, errs = 0, []
        while seen < len(self.qs):
            try:
                token, failed = self.ack_q.get(timeout=5.0)
            except Exception:  # noqa: BLE001 — queue.Empty: health check
                if not self.alive():
                    raise RuntimeError("FAST5 writer process died")
                continue
            if token == self._token:
                seen += 1
                errs.extend(failed)
        return errs

    def shutdown(self):
        for qq in self.qs:
            qq.put(None)
        for p in self.procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.terminate()
                p.join()


_WRITE_POOL: Optional[_ShardedWriters] = None


def _get_write_pool(n: int) -> _ShardedWriters:
    """The process-wide writer pool (spawning costs seconds, paid
    once)."""
    global _WRITE_POOL
    if _WRITE_POOL is None or len(_WRITE_POOL.qs) != n \
            or not _WRITE_POOL.alive():
        shutdown_write_pool()
        _WRITE_POOL = _ShardedWriters(n)
    return _WRITE_POOL


def shutdown_write_pool():
    global _WRITE_POOL
    if _WRITE_POOL is not None:
        _WRITE_POOL.shutdown()
    _WRITE_POOL = None


# --------------------------------------------------------------------------

def estimate_global_scale(fast5_fns, num_reads: Optional[int] = None,
                          source=None) -> float:
    """Median of per-read raw-signal MADs over a shuffled subset
    (reference: tombo/tombo_stats.py:452-476 ``estimate_global_scale``).
    ``source``: where the raw signals come from (default the FAST5
    files)."""
    source = source or Fast5Reads()
    num_reads = num_reads or config.NUM_READS_FOR_SCALE
    fns = list(fast5_fns)
    np.random.shuffle(fns)
    mads = []
    for fn in fns:
        try:
            sig = source.raw(fn)
        except (OSError, TomboError):
            continue
        mads.append(np.median(np.abs(sig - np.median(sig))))
        if len(mads) >= num_reads:
            break
    if not mads:
        raise TomboError(
            "No reads available to estimate the global scale parameter")
    return float(np.median(mads))


def _index_record(res: ResquiggleResults, fn: str, rc: RunConfig,
                  sig_match_thresh: float, rna: bool):
    """(filtered by the signal-matching score, ReadData) of a result."""
    poor_match = res.sig_match_score > sig_match_thresh
    is_filtered = poor_match
    if not poor_match and rc.obs_filter:
        base_lens = np.diff(res.segs)
        is_filtered = any(np.percentile(base_lens, pctl) > thresh
                          for pctl, thresh in rc.obs_filter)
    return poor_match, ReadData(
        res.genome_loc.start, res.genome_loc.start + len(res.segs) - 1,
        is_filtered, res.read_start_rel_to_raw, res.genome_loc.strand, fn,
        rc.corrected_group + "/" + res.align_info.subgroup, rna,
        res.sig_match_score, res.mean_q_score, res.align_info.read_id)


def resquiggle_all_reads(
        fast5s_dir, aligner, std_ref: KmerModel,
        seq_samp_type: SeqSampleType, rsqgl_params,
        rc: Optional[RunConfig] = None,
        resquiggler: Optional[BatchedResquiggler] = None
        ) -> Tuple[RunSummary, Optional[ReadsIndex]]:
    """Re-squiggle every read of ``fast5s_dir``: a directory of FAST5
    files, or a read source (:class:`MemoryReads`).  Returns the summary
    and the reads index (None with ``skip_index``); the index file is
    written for a FAST5 directory unless ``dry_run``."""
    rc = rc or RunConfig()
    t_run = time.perf_counter()
    source = (fast5s_dir if hasattr(fast5s_dir, "read")
              else Fast5Reads(fast5s_dir))
    writes = source.writes and not rc.dry_run
    rna = seq_samp_type.rev_sig
    sig_match_thresh = (rc.sig_match_thresh if rc.sig_match_thresh is not None
                        else config.SIG_MATCH_THRESH[seq_samp_type.name])
    # provenance: the resolved parameters go into every corrected group
    resolved_json = config.resolved_params_json(
        resquiggle=rsqgl_params,
        seq_sample_type=seq_samp_type.name,
        sig_match_thresh=float(sig_match_thresh),
        outlier_thresh=rc.outlier_thresh,
        max_scaling_iters=rc.max_scaling_iters,
        q_score_thresh=rc.q_score_thresh,
        const_scale=rc.const_scale,
        skip_seq_rescaling=rc.skip_seq_rescaling,
        compute_sd=rc.compute_sd)
    multi_host = rc.dist is not None and rc.dist.n_hosts > 1
    lock_fns = (f5io.lock_dirs([source.fast5s_dir], rc.ignore_read_locks)
                if source.writes else [])
    summary = RunSummary()
    timings = summary.timings
    for k in ("io_map", "batch_loop", "writeback"):
        timings[k] = 0.0
    if rc.skip_index:
        reads_index = None
    elif writes:
        reads_index = ReadsIndex([source.fast5s_dir],
                                 corrected_group=rc.corrected_group,
                                 for_writing=True)
    else:
        reads_index = ReadsIndex(corrected_group=rc.corrected_group)
    failed_fp = (open(rc.failed_reads_fn, "w")
                 if rc.failed_reads_fn else None)

    def record_failure(fn, err):
        summary.n_failed += 1
        summary.failure_modes[err] += 1
        if failed_fp is not None:
            failed_fp.write("%s\t%s\n" % (err, fn))

    def write_status(fn, subgrp, err):
        if writes:
            try:
                f5io.write_error_status(fn, rc.corrected_group, subgrp, err)
            except Exception:  # noqa: BLE001 — the status is best-effort
                pass

    map_pool = None
    inline_sidecars = _Sidecars("m")
    try:
        all_fns = source.names()
        if resquiggler is None:
            const_scale = rc.const_scale
            if const_scale is None and rc.fit_global_scale:
                const_scale = estimate_global_scale(all_fns, source=source)
            resquiggler = BatchedResquiggler(
                std_ref, rsqgl_params, seq_samp_type, rc.outlier_thresh,
                dtype=rc.dtype, device=rc.device, mesh=rc.mesh,
                const_scale=const_scale,
                skip_seq_scaling=rc.skip_seq_rescaling)
        batch_size = rc.batch_size * len(resquiggler.mesh)
        if multi_host:
            # this host's disjoint shard of the files (reference analog:
            # the file work queue, tombo/resquiggle.py:1851-1857)
            from ..parallel.distributed import read_shard
            all_fns = [fn for fn in all_fns
                       if read_shard(os.path.basename(fn),
                                     rc.dist.n_hosts) == rc.dist.host_id]

        # --- host stage: one work unit per (file, basecall subgroup)
        # (reference: tombo/resquiggle.py:1612-1656)
        def map_worker(fn):
            t0 = time.perf_counter()
            try:
                return load_and_map(fn, source, aligner, std_ref,
                                    seq_samp_type, rc, rsqgl_params)
            finally:
                timings["io_map"] += time.perf_counter() - t0

        n_units = len(all_fns) * len(rc.basecall_subgroups)
        # processes start before any thread of this run opens a FAST5: a
        # child forked while a thread holds a file open keeps that file's
        # HDF5 lock until it execs, and the thread's next open of the
        # file then fails
        n_wp = rc.num_write_procs
        if n_wp is None:
            n_wp = 3 if n_units >= 256 else 0
        writers = _get_write_pool(n_wp) if n_wp > 0 and writes else None
        ingest_pool = None
        if isinstance(source, Fast5Reads) and n_units >= rc.ingest_min:
            from .ingest import get_ingest_pool
            n_ing = rc.ingest_procs or max(2, min(6,
                                                  (os.cpu_count() or 4) - 1))
            ingest_pool = get_ingest_pool(n_ing, aligner, std_ref,
                                          seq_samp_type, rsqgl_params, rc)
        if ingest_pool is not None:
            map_iter = ingest_pool.run(all_fns)
        else:
            map_pool = ThreadPoolExecutor(max_workers=rc.num_io_threads)
            map_iter = map_pool.map(map_worker, all_fns)

        chunks: List[List[Tuple[str, ResquiggleResults]]] = []
        wait = [0.0]

        def iter_chunks():
            # sort by signal length within a window of two batches, so
            # the padded device shapes of mixed-length data stay tight
            # without holding the device back on short runs
            window: List[Tuple[str, ResquiggleResults]] = []

            def drain():
                window.sort(key=lambda t: t[1].raw_signal.shape[0])
                chunk = window[:batch_size]
                del window[:batch_size]
                chunks.append(chunk)
                return [mr for _, mr in chunk]

            t0 = time.perf_counter()
            for units in map_iter:
                for fn, subgrp, mr, err in units:
                    if err is not None:
                        record_failure(fn, err)
                        write_status(fn, subgrp, err)
                        continue
                    window.append((fn, mr))
                    if len(window) >= batch_size * 2:
                        wait[0] += time.perf_counter() - t0
                        yield drain()
                        t0 = time.perf_counter()
            wait[0] += time.perf_counter() - t0
            while window:
                yield drain()

        # the sidecar lives beside the data, which hosts may share
        sidecar_on = rc.levels_sidecar and not multi_host
        pending_adds: List[tuple] = []    # index adds after the writers' flush

        bar = None
        if rc.progress:
            try:
                from tqdm import tqdm
                bar = tqdm(total=n_units, smoothing=0,
                           desc="Re-squiggling reads")
            except ImportError:
                pass
        t_loop = time.perf_counter()
        t_write = 0.0
        for chunk_i, results in enumerate(resquiggler.resquiggle_batches(
                iter_chunks(), max_scaling_iters=rc.max_scaling_iters)):
            chunk = chunks[chunk_i]
            if len(results) != len(chunk):
                raise RuntimeError("a batch returned %d results for %d "
                                   "reads" % (len(results), len(chunk)))
            if bar is not None:
                bar.update(len(chunk))
                if rc.num_most_common_errors > 0 and summary.failure_modes:
                    # live most-common failures (reference:
                    # tombo/resquiggle.py:1707-1740)
                    bar.set_postfix_str("; ".join(
                        "%d %.40s" % (c, m) for m, c in
                        summary.failure_modes.most_common(
                            rc.num_most_common_errors)), refresh=False)
            t0 = time.perf_counter()
            for (fn, mr), (res, err) in zip(chunk, results):
                if err is not None:
                    record_failure(fn, err)
                    write_status(fn, mr.align_info.subgroup, err)
                    continue
                if res.align_info is not mr.align_info:
                    raise RuntimeError("a batch's results are out of order")
                if writes:
                    try:
                        if writers is not None:
                            writers.submit(fn, res, rc.corrected_group,
                                           rc.compute_sd, rna, resolved_json,
                                           sidecar_on)
                        else:
                            _write_one(fn, res, rc.corrected_group,
                                       rc.compute_sd, rna, resolved_json,
                                       inline_sidecars if sidecar_on
                                       else None)
                    except Exception:  # noqa: BLE001 — a failed read
                        record_failure(fn, "FAST5 write error")
                        continue
                summary.n_success += 1
                if reads_index is None:
                    continue
                poor_match, rd = _index_record(res, fn, rc,
                                               sig_match_thresh, rna)
                if poor_match:
                    summary.failure_modes[POOR_MATCH] += 1
                add = (res.genome_loc.chrom, res.genome_loc.strand, rd)
                if writers is not None:
                    pending_adds.append(((fn, res.align_info.subgroup),)
                                        + add)
                else:
                    reads_index.add_read_data(*add)
            t_write += time.perf_counter() - t0
        timings["batch_loop"] = (time.perf_counter() - t_loop - wait[0] -
                                 t_write)

        t0 = time.perf_counter()
        if writers is not None:
            werrs = writers.flush()
            failed_keys = set(werrs)
            for wfn, wsub in werrs:
                record_failure(wfn, "FAST5 write error")
                write_status(wfn, wsub, "FAST5 write error")
                summary.n_success -= 1
            for key, chrm, strand, rd in pending_adds:
                if key not in failed_keys and reads_index is not None:
                    reads_index.add_read_data(chrm, strand, rd)
        timings["writeback"] = t_write + time.perf_counter() - t0
        if bar is not None:
            bar.close()
        if reads_index is not None and writes:
            reads_index.write_index_file(
                ".host%d" % rc.dist.host_id if multi_host else "")
    finally:
        if map_pool is not None:
            map_pool.shutdown(wait=True)
        inline_sidecars.close()
        if failed_fp is not None:
            failed_fp.close()
        f5io.clear_locks(lock_fns)
    timings["run"] = time.perf_counter() - t_run
    if rc.profile:
        for name, t in timings.items():
            print("  %-12s %9.3f s" % (name, t))
    return summary, reads_index
