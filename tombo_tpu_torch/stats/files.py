"""Statistics files: ``ModelStats`` (per-read tests), ``LevelStats``
(group level tests) and ``PerReadStats`` (copy of
``tombo_tpu/stats/files.py``).

The HDF5 layout is the reference's (reference: tombo/tombo_stats.py:
2554-3565): per-region ``Statistic_Blocks`` groups, a
``Most_Significant_Stats`` table with a chrm-id map, and the
dampened-fraction pseudo-count attributes, so the JAX package, the
reference and this port read each other's files.  ``h5py`` is imported
inside the methods that open a file."""
from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict

import numpy as np

from ..errors import TomboError
from ..types import GroupStats, RegionStats
from .kernels import calc_damp_fraction

STAT_BLOCKS_H5_NAME = "Statistic_Blocks"
MOST_SIGNIF_H5_NAME = "Most_Significant_Stats"
COV_DAMP_COUNTS_H5_NAME = "Cov_Damp_Counts"
COV_THRESH_H5_NAME = "Cov_Threshold"
MOST_SIGNIF_NUM_BATCHES_DEFAULT = 10

# statistic type names (reference: tombo/tombo_stats.py:91-112)
SAMP_COMP_TXT = "sample_compare"
DE_NOVO_TXT = "de_novo"
ALT_MODEL_TXT = "model_compare"
KS_TEST_TXT = "ks"
U_TEST_TXT = "u"
T_TEST_TXT = "t"
KS_STAT_TEST_TXT = "ks_stat"
U_STAT_TEST_TXT = "u_stat"
T_STAT_TEST_TXT = "t_stat"
PER_READ_STATS = (SAMP_COMP_TXT, DE_NOVO_TXT, ALT_MODEL_TXT)
LEVEL_STATS_TXTS = (KS_TEST_TXT, U_TEST_TXT, T_TEST_TXT,
                    KS_STAT_TEST_TXT, U_STAT_TEST_TXT, T_STAT_TEST_TXT)

_MODEL_DTYPE = [("damp_frac", "f8"), ("frac", "f8"), ("pos", "u4"),
                ("cov", "u4"), ("control_cov", "u4"), ("valid_cov", "u4")]
_LEVEL_DTYPE = [("stat", "f8"), ("pos", "u4"), ("cov", "u4"),
                ("control_cov", "u4")]


class _StatsFileBase:
    stat_slot: str

    def set_resolved_params(self, resolved_json: str):
        """Record the fully-resolved parameter set (a JSON string from
        ``config.resolved_params_json``) in the stats file for output
        provenance (SURVEY §5.6 TPU-equivalent reproducibility note)."""
        if resolved_json is not None and self.open_for_writing:
            self._fp.attrs["resolved_params"] = resolved_json

    def _parse(self):
        import h5py
        self._fp = h5py.File(self.stats_fn, "r")
        self.resolved_params = _dec(self._fp.attrs.get("resolved_params"))
        self.stat_type = _dec(self._fp.attrs.get("stat_type"))
        self.region_size = int(self._fp.attrs.get("block_size"))
        self.stat_blocks = self._fp[STAT_BLOCKS_H5_NAME]
        self.num_blocks = 0
        blocks_index: Dict = defaultdict(dict)
        for block_name, block_data in self.stat_blocks.items():
            blocks_index[(_dec(block_data.attrs.get("chrm")),
                          _dec(block_data.attrs.get("strand")))][
                int(block_data.attrs.get("start"))] = block_name
            self.num_blocks += 1
        self.blocks_index = dict(blocks_index)
        self.cov_thresh = self._fp.attrs.get(COV_THRESH_H5_NAME)
        ms_grp = self._fp[MOST_SIGNIF_H5_NAME]
        self.most_signif_stats = ms_grp[MOST_SIGNIF_H5_NAME][:]
        self.most_signif_chrm_map = dict(
            (v, k) for k, v in ms_grp["chrm_ids"].attrs.items())
        try:
            self.cov_damp_counts = dict(
                self._fp[COV_DAMP_COUNTS_H5_NAME].attrs.items())
        except KeyError:
            self.cov_damp_counts = None

    # ---------------------------------------------------------- shared IO
    def _new_file_common(self):
        import h5py
        try:
            os.remove(self.stats_fn)
        except OSError:
            pass
        self._fp = h5py.File(self.stats_fn, "w")
        self._fp.attrs["stat_type"] = self.stat_type
        self._fp.attrs["block_size"] = self.region_size
        self.stat_blocks = self._fp.create_group(STAT_BLOCKS_H5_NAME)
        self._fp.attrs[COV_THRESH_H5_NAME] = self.cov_thresh
        self.most_signif_sites = self._fp.create_group(MOST_SIGNIF_H5_NAME)
        self.queued_stat_batches = []
        self.curr_chrm_id = 0
        self.chrm_names: Dict[str, int] = {}
        self.chrm_id_grp = self.most_signif_sites.create_group("chrm_ids")
        self.curr_block_num = 0
        self.is_empty = True

    def _update_most_signif(self):
        # ``sort(order=stat_slot)`` on a structured array compares the
        # stat first and the REMAINING FIELDS in dtype order on ties,
        # through slow per-record void comparisons (~35% of detection
        # compute, bench --stats).  Reproduce the exact ordering with a
        # column-wise lexsort, and drop the all-identical NaN padding
        # rows before sorting (re-appended by the [:N] cut).
        running = self.running_most_signif_sites
        slot = running[self.stat_slot]
        n_filled = int(np.searchsorted(slot, np.inf))  # NaNs sort last
        if n_filled < running.shape[0] and np.isnan(slot[n_filled:]).all():
            pad = running[n_filled:]
            running = running[:n_filled]
        else:
            pad = running[:0]
        tmp = np.concatenate([running] + self.queued_stat_batches)
        names = [self.stat_slot] + [
            n for n in tmp.dtype.names if n != self.stat_slot]
        keys = []
        for n in reversed(names):  # lexsort: last key is primary
            col = tmp[n]
            keys.append(col.view(np.uint8) if col.dtype.kind == "S"
                        else col)
        order = np.lexsort(keys)
        tmp = tmp[order[:self.num_most_signif]]
        if tmp.shape[0] < self.num_most_signif:
            tmp = np.concatenate(
                [tmp, pad[:self.num_most_signif - tmp.shape[0]]])
        self.running_most_signif_sites = tmp
        self.queued_stat_batches = []

    def _add_to_most_signif(self, reg_stats_arr, chrm, strand):
        if chrm not in self.chrm_names:
            self.chrm_names[chrm] = self.curr_chrm_id
            self.curr_chrm_id += 1
        ext = np.empty(reg_stats_arr.shape[0],
                       dtype=self.running_most_signif_sites.dtype)
        for name in reg_stats_arr.dtype.names:
            ext[name] = reg_stats_arr[name]
        ext["chrm"] = self.chrm_names[chrm]
        ext["strand"] = strand.encode() if isinstance(strand, str) else strand
        self.queued_stat_batches.append(ext)
        if len(self.queued_stat_batches) >= self.most_signif_num_batches:
            self._update_most_signif()

    def _close_write(self):
        if len(self.queued_stat_batches) >= 1:
            self._update_most_signif()
        slot = self.running_most_signif_sites[self.stat_slot]
        if slot.shape[0] and np.isnan(slot[-1]):
            first_nan = np.where(np.isnan(slot))[0][0]
            self.running_most_signif_sites = \
                self.running_most_signif_sites[:first_nan]
        self.most_signif_sites.create_dataset(
            MOST_SIGNIF_H5_NAME, data=self.running_most_signif_sites,
            compression="gzip")
        for chrm_name, chrm_id in self.chrm_names.items():
            self.chrm_id_grp.attrs[chrm_name] = chrm_id

    def close(self):
        if self.open_for_writing:
            self._close_write()
        self._fp.close()

    # -------------------------------------------------------------- reads
    def __iter__(self):
        """Yield (chrm, strand, start, end, block_stats) over all blocks
        (reference: tombo/tombo_stats.py:2984-3010)."""
        for (chrm, strand) in sorted(self.blocks_index):
            for start, block_name in sorted(
                    self.blocks_index[(chrm, strand)].items()):
                yield (chrm, strand, start, start + self.region_size,
                       self.stat_blocks[block_name]["block_stats"][:])

    def _get_chrm_name(self, pos_stat):
        return _dec(self.most_signif_chrm_map[pos_stat["chrm"]])

    def iter_most_signif_sites(self):
        """(chrm, strand, pos, transformed statistic) of the stored most
        significant sites, most significant first."""
        for pos_stat in self.most_signif_stats:
            yield (self._get_chrm_name(pos_stat),
                   pos_stat["strand"].decode(), int(pos_stat["pos"]),
                   self._stat_transform(pos_stat))

    def get_reg_stats(self, chrm, strand, start, end):
        """The per-site records of the blocks overlapping [start, end),
        cut to it; None where there are none."""
        if (chrm, strand) not in self.blocks_index:
            return None
        collected = []
        for block_start, block_name in sorted(
                self.blocks_index[(chrm, strand)].items()):
            if end <= block_start or start >= block_start + self.region_size:
                continue
            bs = self.stat_blocks[block_name]["block_stats"][:]
            collected.append(bs[(bs["pos"] >= start) & (bs["pos"] < end)])
        if not collected:
            return None
        return np.concatenate(collected)

    def get_most_signif_regions(self, num_bases, num_regions,
                                unique_pos=True, prepend_loc_to_text=False):
        """Intervals of ``num_bases`` centred on the most significant
        sites (reference: tombo/tombo_stats.py:2864-2920)."""
        selected = []
        used = defaultdict(set)
        for i, pos_stat in enumerate(self.most_signif_stats):
            int_start = max(0, int(pos_stat["pos"]) - num_bases // 2)
            chrm = self._get_chrm_name(pos_stat)
            strand = pos_stat["strand"].decode()
            if not unique_pos or \
                    int(pos_stat["pos"]) not in used[(chrm, strand)]:
                used[(chrm, strand)].update(
                    range(int_start, int_start + num_bases))
                txt = self._stat_text.format(self._stat_transform(pos_stat))
                if prepend_loc_to_text:
                    txt = "{0}:{1:d}:{2}".format(
                        chrm, int(pos_stat["pos"]) + 1, strand) + " " + txt
                selected.append((chrm, int_start, int_start + num_bases,
                                 strand, "{:03d}".format(i), txt))
                if len(selected) >= num_regions:
                    break
        return selected


def _dec(v):
    return v.decode() if isinstance(v, bytes) else v


def _nan_fill(arr: np.ndarray) -> np.ndarray:
    """NaN-fill float fields of a structured array (numpy>=1.24 rejects
    whole-record NaN assignment on mixed dtypes)."""
    for name in arr.dtype.names:
        if arr.dtype.fields[name][0].kind == "f":
            arr[name] = np.nan
    return arr


class ModelStats(_StatsFileBase):
    """Per-genomic-base fraction statistics file
    (reference: tombo/tombo_stats.py:2554 ``ModelStats``)."""

    stat_slot = "damp_frac"

    def __init__(self, stats_fn, stat_type=None, region_size=None,
                 cov_damp_counts=None, cov_thresh=None, num_most_signif=None,
                 most_signif_num_batches=MOST_SIGNIF_NUM_BATCHES_DEFAULT):
        self.stats_fn = stats_fn
        if any(a is None for a in (stat_type, region_size, cov_damp_counts,
                                   cov_thresh, num_most_signif)):
            self.open_for_writing = False
            try:
                self._parse()
            except (OSError, KeyError, TypeError, ValueError):
                raise TomboError("Invalid statistics file provided.")
        else:
            self.open_for_writing = True
            self.stat_type = stat_type
            self.region_size = region_size
            self.cov_damp_counts = dict(
                zip(("unmod", "mod"), cov_damp_counts))
            self.cov_thresh = cov_thresh
            self.num_most_signif = num_most_signif
            self.most_signif_num_batches = most_signif_num_batches
            self._new_file_common()
            grp = self._fp.create_group(COV_DAMP_COUNTS_H5_NAME)
            grp.attrs["unmod"] = self.cov_damp_counts["unmod"]
            grp.attrs["mod"] = self.cov_damp_counts["mod"]
            self.running_most_signif_sites = _nan_fill(np.zeros(
                (self.num_most_signif,),
                dtype=_MODEL_DTYPE + [("chrm", "u4"), ("strand", "S1")]))
        if self.stat_type not in PER_READ_STATS:
            if self.stat_type in LEVEL_STATS_TXTS:
                raise TomboError(
                    "This appears to be a group-comparison stats file. "
                    "Open with LevelStats.")
            raise TomboError(
                'This file is not a valid ModelStats file. `stat_type` '
                'listed as "%s".' % self.stat_type)
        self._stat_text = "Est. Frac. Alternate: {0:.2g}"
        self._stat_transform = lambda ps: 1 - ps[self.stat_slot]

    def _write_stat_block(self, reg_stats: RegionStats):
        block_data = self.stat_blocks.create_group(
            "Block_" + str(self.curr_block_num))
        self.curr_block_num += 1
        block_data.attrs["chrm"] = reg_stats.chrm
        block_data.attrs["strand"] = reg_stats.strand
        block_data.attrs["start"] = reg_stats.start
        damp_frac = calc_damp_fraction(
            (self.cov_damp_counts["unmod"], self.cov_damp_counts["mod"]),
            reg_stats.reg_frac_standard_base, reg_stats.valid_cov)
        # vectorized row build (a per-site python tuple loop here was
        # the leader's dominant serial cost in multi-host detection);
        # columns clip to the shortest array exactly as zip() did
        cols = [np.asarray(damp_frac),
                np.asarray(reg_stats.reg_frac_standard_base),
                np.asarray(reg_stats.reg_poss),
                np.asarray(reg_stats.reg_cov),
                np.asarray(reg_stats.ctrl_cov),
                np.asarray(reg_stats.valid_cov)]
        m = min(c.shape[0] for c in cols)
        keep = ~np.isnan(cols[0][:m].astype(np.float64))
        reg_stats_arr = np.empty(int(keep.sum()), dtype=_MODEL_DTYPE)
        for name, c in zip(("damp_frac", "frac", "pos", "cov",
                            "control_cov", "valid_cov"), cols):
            reg_stats_arr[name] = c[:m][keep]
        block_data.create_dataset("block_stats", data=reg_stats_arr,
                                  compression="gzip")
        self._add_to_most_signif(reg_stats_arr, reg_stats.chrm,
                                 reg_stats.strand)
        self.is_empty = False


class LevelStats(_StatsFileBase):
    """Group-comparison (level test) statistics file (reference:
    tombo/tombo_stats.py:3063 ``LevelStats``)."""

    stat_slot = "stat"

    def __init__(self, stats_fn, stat_type=None, region_size=None,
                 cov_thresh=None, num_most_signif=None,
                 most_signif_num_batches=MOST_SIGNIF_NUM_BATCHES_DEFAULT):
        self.stats_fn = stats_fn
        if any(a is None for a in (stat_type, region_size, cov_thresh,
                                   num_most_signif)):
            self.open_for_writing = False
            try:
                self._parse()
            except (OSError, KeyError, TypeError, ValueError):
                raise TomboError("Invalid statistics file provided.")
        else:
            self.open_for_writing = True
            self.stat_type = stat_type
            self.region_size = region_size
            self.cov_thresh = cov_thresh
            self.num_most_signif = num_most_signif
            self.most_signif_num_batches = most_signif_num_batches
            self._new_file_common()
            self.running_most_signif_sites = _nan_fill(np.zeros(
                (self.num_most_signif,),
                dtype=_LEVEL_DTYPE + [("chrm", "u4"), ("strand", "S1")]))
        if self.stat_type not in LEVEL_STATS_TXTS:
            raise TomboError(
                "This does not appear to be a group-comparison stats file.")
        if self.stat_type in (KS_TEST_TXT, U_TEST_TXT, T_TEST_TXT):
            self._stat_text = "-log10(p-value): {0:.2g}"

            def neg_log10(ps):
                with np.errstate(divide="ignore"):
                    return -np.log10(ps[self.stat_slot])
            self._stat_transform = neg_log10
        elif self.stat_type == KS_STAT_TEST_TXT:
            self._stat_text = "D Statistic: {0:.2g}"
            self._stat_transform = lambda ps: 1 - ps[self.stat_slot]
        elif self.stat_type == U_STAT_TEST_TXT:
            self._stat_text = "Common Language Marginal Effect: {0:.2g}"
            self._stat_transform = lambda ps: -ps[self.stat_slot]
        else:
            self._stat_text = "Cohen's D: {0:.2g}"
            self._stat_transform = lambda ps: -ps[self.stat_slot]

    def _write_stat_block(self, grp_stats: GroupStats):
        block_data = self.stat_blocks.create_group(
            "Block_" + str(self.curr_block_num))
        self.curr_block_num += 1
        block_data.attrs["chrm"] = grp_stats.chrm
        block_data.attrs["strand"] = grp_stats.strand
        block_data.attrs["start"] = grp_stats.start
        cols = [np.asarray(grp_stats.reg_stats),
                np.asarray(grp_stats.reg_poss),
                np.asarray(grp_stats.reg_cov),
                np.asarray(grp_stats.ctrl_cov)]
        m = min(c.shape[0] for c in cols)
        keep = ~np.isnan(cols[0][:m].astype(np.float64))
        arr = np.empty(int(keep.sum()), dtype=_LEVEL_DTYPE)
        for name, c in zip(("stat", "pos", "cov", "control_cov"), cols):
            arr[name] = c[:m][keep]
        block_data.create_dataset("block_stats", data=arr,
                                  compression="gzip")
        self._add_to_most_signif(arr, grp_stats.chrm, grp_stats.strand)
        self.is_empty = False


class PerReadStats:
    """Per-read statistics file (reference: tombo/tombo_stats.py:3239
    ``PerReadStats``): per region a block of (pos, stat, read_id)
    records and the read ids' names."""

    def __init__(self, per_read_stats_fn, stat_type=None, region_size=None):
        self.per_read_stats_fn = per_read_stats_fn
        if stat_type is None or region_size is None:
            self.open_for_writing = False
            try:
                self._parse()
            except (OSError, KeyError, TypeError, ValueError):
                raise TomboError(
                    "Non-existent or invalid per-read statistics file "
                    "provided.")
        else:
            import h5py
            self.open_for_writing = True
            self.stat_type = stat_type
            self.region_size = region_size
            try:
                os.remove(per_read_stats_fn)
            except OSError:
                pass
            self._fp = h5py.File(per_read_stats_fn, "w")
            self.curr_block_num = 0
            self._fp.attrs["stat_type"] = stat_type
            self._fp.attrs["block_size"] = region_size
            self.per_read_blocks = self._fp.create_group(STAT_BLOCKS_H5_NAME)
        self.are_pvals = self.stat_type != ALT_MODEL_TXT

    def set_resolved_params(self, resolved_json: str):
        if resolved_json is not None and self.open_for_writing:
            self._fp.attrs["resolved_params"] = resolved_json

    def _parse(self):
        import h5py
        self._fp = h5py.File(self.per_read_stats_fn, "r")
        self.resolved_params = _dec(self._fp.attrs.get("resolved_params"))
        self.stat_type = _dec(self._fp.attrs.get("stat_type"))
        self.region_size = int(self._fp.attrs.get("block_size"))
        self.per_read_blocks = self._fp[STAT_BLOCKS_H5_NAME]
        self.num_blocks = 0
        blocks_index: Dict = defaultdict(dict)
        for block_name, block_data in self.per_read_blocks.items():
            blocks_index[(_dec(block_data.attrs.get("chrm")),
                          _dec(block_data.attrs.get("strand")))][
                int(block_data.attrs.get("start"))] = block_name
            self.num_blocks += 1
        self.blocks_index = dict(blocks_index)

    def _write_per_read_block(self, per_read_block, read_id_lookup,
                              chrm, strand, start):
        import h5py
        block_data = self.per_read_blocks.create_group(
            "Block_" + str(self.curr_block_num))
        self.curr_block_num += 1
        block_data.attrs["chrm"] = chrm
        block_data.attrs["strand"] = strand
        block_data.attrs["start"] = start
        block_data.create_dataset("block_stats", data=per_read_block,
                                  compression="gzip")
        dt = h5py.special_dtype(vlen=str)
        read_ids = np.array(list(read_id_lookup.keys()), dtype=dt)
        ds = block_data.create_dataset("read_ids", read_ids.shape, dtype=dt,
                                       compression="gzip")
        ds[...] = read_ids
        block_data.create_dataset(
            "read_id_vals", data=np.array(list(read_id_lookup.values())),
            compression="gzip")
        self._fp.flush()

    def _block(self, block_name):
        grp = self.per_read_blocks[block_name]
        lookup = dict(zip(grp["read_id_vals"][()],
                          (_dec(r) for r in grp["read_ids"][()])))
        return grp["block_stats"][:], lookup

    def iter_per_read_blocks(self):
        """(chrm, strand, start, block records, {number: read id}) of
        every block."""
        for (chrm, strand), starts in self.blocks_index.items():
            for start, block_name in sorted(starts.items()):
                yield (chrm, strand, start) + self._block(block_name)

    def get_region_per_read_stats(self, chrm, strand, start, end,
                                  num_reads=None):
        """(pos, stat, read id string) records over [start, end)
        (reference: tombo/tombo_stats.py:3370-3430); ``num_reads``: a
        random sample of that many reads."""
        if (chrm, strand) not in self.blocks_index:
            return None
        collected = []
        for block_start, block_name in self.blocks_index[
                (chrm, strand)].items():
            if end < block_start or start > block_start + self.region_size:
                continue
            block_stats, lookup = self._block(block_name)
            collected.append(np.array(
                list(zip(block_stats["pos"], block_stats["stat"],
                         [lookup[r] for r in block_stats["read_id"]])),
                dtype=[("pos", "u4"), ("stat", "f8"), ("read_id", object)]))
        if not collected:
            return None
        allb = (collected[0] if len(collected) == 1
                else np.concatenate(collected))
        allb = allb[(allb["pos"] >= start) & (allb["pos"] < end)]
        if num_reads is not None:
            import random
            read_ids = set(allb["read_id"])
            if num_reads < len(read_ids):
                keep = set(random.sample(sorted(read_ids), num_reads))
                allb = allb[np.array([r in keep for r in allb["read_id"]])]
        return allb

    def close(self):
        self._fp.close()
