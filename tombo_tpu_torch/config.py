"""The re-squiggle and detection constants and the re-squiggle parameter
bundle the DNA and RNA paths read.

A subset copy of ``tombo_tpu/config.py`` (values unchanged; they are the
reference Tombo's tuned constants, reference:
tombo/_default_parameters.py)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

DNA_SAMP_TYPE = "DNA"
RNA_SAMP_TYPE = "RNA"

STANDARD_MODELS = {
    DNA_SAMP_TYPE: "tombo.DNA.model.npz",
    RNA_SAMP_TYPE: "tombo.RNA.180mV.model.npz",
}
# bundled alternative-base models, "<sample type>_<name>" -> file
# (reference: tombo/_default_parameters.py:11-22)
ALTERNATE_MODELS = {
    DNA_SAMP_TYPE + "_5mC": "tombo.DNA.5mC.model.npz",
    DNA_SAMP_TYPE + "_6mA": "tombo.DNA.6mA.model.npz",
    DNA_SAMP_TYPE + "_dcm": "tombo.DNA.dcm.model.npz",
    DNA_SAMP_TYPE + "_dam": "tombo.DNA.dam.model.npz",
    DNA_SAMP_TYPE + "_CpG": "tombo.DNA.CpG.model.npz",
    RNA_SAMP_TYPE + "_5mC": "tombo.RNA.5mC.model.npz",
}


@dataclass(frozen=True)
class SegParams:
    running_stat_width: int
    min_obs_per_base: int
    raw_min_obs_per_base: int
    mean_obs_per_event: int


SEG_PARAMS_TABLE = {
    RNA_SAMP_TYPE: SegParams(12, 6, 2, 15),
    DNA_SAMP_TYPE: SegParams(5, 3, 1, 5),
}


@dataclass(frozen=True)
class AlignParams:
    match_evalue: float
    skip_pen: float
    bandwidth: int
    save_bandwidth: int
    max_half_z_score: Optional[float]
    band_bound_thresh: int
    start_bw: int
    start_save_bw: int
    start_n_bases: int


ALGN_PARAMS_TABLE = {
    RNA_SAMP_TYPE: AlignParams(6, 4, 500, 1500, 20.0, 50, 1000, 3000, 250),
    DNA_SAMP_TYPE: AlignParams(4.2, 4.2, 300, 1500, 20.0, 40, 750, 2500, 250),
}

SIG_MATCH_THRESH = {RNA_SAMP_TYPE: 2.0, DNA_SAMP_TYPE: 1.1}
OUTLIER_THRESH = 5.0

EXTRA_SIG_FACTOR = 1.1
DEL_FIX_WINDOW = 2
MAX_DEL_FIX_WINDOW = 10
MAX_RAW_CPTS = 200
MIN_EVENT_TO_SEQ_RATIO = 1.1

MASK_BASES = 50
MASK_FILL_Z_SCORE = -15.0

SHIFT_CHANGE_THRESH = 0.1
SCALE_CHANGE_THRESH = 0.1
MAX_SCALING_ITERS = 3
MAX_POINTS_FOR_THEIL_SEN = 1000

HALF_NORM_EXPECTED_VAL = 0.7978845608028654

# RNA event-based scaling (reference: _default_parameters.py:78-80; the
# port implements only the reference's default, USE_RNA_EVENT_SCALE on)
RNA_SCALE_NUM_EVENTS = 10000
RNA_SCALE_MAX_FRAC_EVENTS = 0.75

# stall collapsing (reference: _default_parameters.py:84-97)
COLLAPSE_RNA_STALLS = True
COLLAPSE_DNA_STALLS = False


@dataclass(frozen=True)
class StallParams:
    """Pore-stall identification: the mean-window method (``n_windows``,
    ``mini_window_size``, the default) or the percentile method
    (``lower_pctl``, ``upper_pctl``)."""

    window_size: int
    threshold: float
    edge_buffer: int
    min_consecutive_obs: int
    n_windows: Optional[int] = None
    mini_window_size: Optional[int] = None
    lower_pctl: Optional[float] = None
    upper_pctl: Optional[float] = None


MEAN_STALL_PARAMS = StallParams(
    window_size=7 * 50, threshold=40, edge_buffer=100,
    min_consecutive_obs=200, n_windows=7, mini_window_size=50)
PCTL_STALL_PARAMS = StallParams(
    window_size=400, threshold=100, edge_buffer=50,
    min_consecutive_obs=200, lower_pctl=5, upper_pctl=95)
DEFAULT_STALL_PARAMS = MEAN_STALL_PARAMS


@dataclass(frozen=True)
class TrimRnaParams:
    """RNA adapter trimming, off by default (reference:
    tombo/tombo_stats.py:121-123)."""

    moving_window_size: int = 50
    min_running_values: int = 100
    thresh_scale: float = 0.7
    max_raw_obs: int = 40000


DEFAULT_TRIM_RNA_PARAMS = TrimRnaParams()


@dataclass(frozen=True)
class ResquiggleParams:
    """Fully-derived re-squiggle parameter bundle (counterpart of
    ``tombo_tpu.config.ResquiggleParams``, same fields)."""

    match_evalue: float
    skip_pen: float
    bandwidth: int
    max_half_z_score: Optional[float]
    running_stat_width: int
    min_obs_per_base: int
    raw_min_obs_per_base: int
    mean_obs_per_event: int
    z_shift: float
    stay_pen: float
    use_t_test_seg: bool
    band_bound_thresh: int
    start_bw: int
    start_save_bw: int
    start_n_bases: int

    def replace(self, **kw) -> "ResquiggleParams":
        return dataclasses.replace(self, **kw)


# per-read testing thresholds, (lower, upper): log-likelihood ratios
# of the alternative-model test, p-values of the others (reference:
# _default_parameters.py:107-118)
LLR_THRESH = {DNA_SAMP_TYPE: (-1.5, 2.5), RNA_SAMP_TYPE: (-2.5, 2.5)}
SAMP_COMP_THRESH = {DNA_SAMP_TYPE: (0.15, 0.5), RNA_SAMP_TYPE: (0.05, 0.4)}
DE_NOVO_THRESH = {DNA_SAMP_TYPE: (0.15, 0.5), RNA_SAMP_TYPE: (0.05, 0.4)}

# the outlier-robust scaled log-likelihood ratio (reference:
# _default_parameters.py:132-134)
OCLLHR_SCALE = 4.0
OCLLHR_HEIGHT = 1.0
OCLLHR_POWER = 0.2
# the canonical model's SD is taken as constant (reference:
# tombo/tombo_stats.py:112)
CONST_SD_MODEL = True

# Fisher's method window offset (reference: _default_parameters.py:136)
FM_OFFSET_DEFAULT = 1

# posterior priors of control-sample levels (reference:
# _default_parameters.py:139-140)
MEAN_PRIOR_CONST = 5.0
SD_PRIOR_CONST = 40.0

SMALLEST_PVAL = 1e-50
# beta-prior pseudo-counts (unmod, mod) of the dampened fraction
COV_DAMP_COUNTS = (2.0, 0.0)

# genome-block size of a detection pass (reference:
# tombo/_option_parsers.py:290-291 --multiprocess-region-size)
DEFAULT_REGION_SIZE = 10000

# HDF5 group names (reference: tombo/_option_parsers.py:100-101)
DEFAULT_CORRECTED_GROUP = "RawGenomeCorrected_000"
DEFAULT_BASECALL_GROUP = "Basecall_1D_000"
DEFAULT_BASECALL_SUBGROUP = "BaseCalled_template"

# reads whose raw-signal MADs estimate the global scale (reference:
# _default_parameters.py:158-197)
NUM_READS_FOR_SCALE = 1000

# model estimation (reference: tombo/_default_parameters.py:147-152,
# 158-197): observations kept per k-mer by the density estimate, the
# fewest a k-mer may have to be estimated, the density grid, and the
# reads the re-centring fit takes
MAX_KMER_OBS = 10000
MIN_KMER_OBS_TO_EST = 50
KERNEL_DENSITY_RANGE = (-5, 5)
NUM_DENS_POINTS = 500
NUM_READS_TO_ADJUST_MODEL = 5000
# central base of a nanopolish-style text model
NANOPOLISH_CENTRAL_POS = 2

# robust-median normalization's shift: the mean of these percentiles of
# the raw signal (tombo_tpu/config.py:195)
ROBUST_QUANTS = (46.5, 53.5)
# points of a plotted ROC or precision-recall curve
# (tombo_tpu/config.py:203)
ROC_PLOT_POINTS = 1000


def get_dynamic_prog_params(match_evalue: float) -> Tuple[float, float]:
    """(z_shift, stay_pen) from the expected match e-value."""
    return HALF_NORM_EXPECTED_VAL + match_evalue, match_evalue


def load_resquiggle_parameters(seq_samp_type: str,
                               use_save_bandwidth: bool = False
                               ) -> ResquiggleParams:
    ap = ALGN_PARAMS_TABLE[seq_samp_type]
    sp = SEG_PARAMS_TABLE[seq_samp_type]
    z_shift, stay_pen = get_dynamic_prog_params(ap.match_evalue)
    return ResquiggleParams(
        match_evalue=ap.match_evalue, skip_pen=ap.skip_pen,
        bandwidth=ap.save_bandwidth if use_save_bandwidth else ap.bandwidth,
        max_half_z_score=ap.max_half_z_score,
        running_stat_width=sp.running_stat_width,
        min_obs_per_base=sp.min_obs_per_base,
        raw_min_obs_per_base=sp.raw_min_obs_per_base,
        mean_obs_per_event=sp.mean_obs_per_event,
        z_shift=z_shift, stay_pen=stay_pen,
        use_t_test_seg=seq_samp_type == RNA_SAMP_TYPE,
        band_bound_thresh=ap.band_bound_thresh,
        start_bw=ap.start_bw, start_save_bw=ap.start_save_bw,
        start_n_bases=ap.start_n_bases)


def resolved_params_json(**params) -> str:
    """The fully-resolved parameters as JSON, recorded in stats files for
    provenance (the JAX package's ``config.resolved_params_json``, same
    output for the same keyword arguments)."""
    import json

    import numpy as np

    def to_plain(v):
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return {k: to_plain(x)
                    for k, x in dataclasses.asdict(v).items()}
        if isinstance(v, (tuple, list)):
            return [to_plain(x) for x in v]
        if isinstance(v, np.integer):
            return int(v)
        if isinstance(v, np.floating):
            return float(v)
        return v

    return json.dumps({k: to_plain(v) for k, v in params.items()},
                      sort_keys=True)
