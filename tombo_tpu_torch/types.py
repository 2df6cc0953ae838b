"""Record types of the re-squiggle and detection paths (subset copy of
``tombo_tpu/types.py``; reference: tombo/tombo_helper.py namedtuples)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class AlignInfo:
    read_id: str = ""
    subgroup: str = "BaseCalled_template"
    clip_start: int = 0
    clip_end: int = 0
    insertions: int = 0
    deletions: int = 0
    matches: int = 0
    mismatches: int = 0


@dataclass
class GenomeLocation:
    start: int
    strand: str
    chrom: str


@dataclass
class ScaleValues:
    shift: float
    scale: float
    lower_lim: Optional[float] = None
    upper_lim: Optional[float] = None
    outlier_thresh: Optional[float] = None

    def replace(self, **kw) -> "ScaleValues":
        return dataclasses.replace(self, **kw)


@dataclass
class SeqSampleType:
    name: str
    rev_sig: bool


@dataclass
class SequenceData:
    seq: str
    id: str
    mean_q_score: float


@dataclass
class ChannelInfo:
    """Reference: tombo/tombo_helper.py:288-298 ``channelInfo``."""
    offset: float
    range: float
    digitisation: float
    number: int = 0
    sampling_rate: int = 4000


@dataclass
class DpResults:
    read_start_rel_to_raw: int
    segs: np.ndarray
    ref_means: np.ndarray
    ref_sds: np.ndarray
    genome_seq: str


@dataclass
class ResquiggleResults:
    align_info: Optional[AlignInfo] = None
    genome_loc: Optional[GenomeLocation] = None
    genome_seq: Optional[str] = None
    mean_q_score: Optional[float] = None
    raw_signal: Optional[np.ndarray] = None
    read_start_rel_to_raw: Optional[int] = None
    segs: Optional[np.ndarray] = None
    scale_values: Optional[ScaleValues] = None
    sig_match_score: Optional[float] = None
    norm_params_changed: Optional[bool] = None
    start_clip_bases: Optional[str] = None
    stall_ints: Optional[List[Tuple[int, int]]] = None

    def replace(self, **kw) -> "ResquiggleResults":
        return dataclasses.replace(self, **kw)


@dataclass
class ReadData:
    """Per-read index record (reference: tombo/tombo_helper.py:127-158
    ``readData``)."""
    start: int
    end: int
    filtered: bool
    read_start_rel_to_raw: int
    strand: str
    fn: str
    corr_group: str
    rna: bool
    sig_match_score: Optional[float] = None
    mean_q_score: Optional[float] = None
    read_id: Optional[str] = None


@dataclass
class RegionStats:
    """Per-region fraction statistics block (reference:
    tombo/tombo_helper.py:300-316 ``regionStats``)."""
    reg_frac_standard_base: np.ndarray
    reg_poss: np.ndarray
    chrm: str
    strand: str
    start: int
    reg_cov: np.ndarray
    ctrl_cov: np.ndarray
    valid_cov: np.ndarray


@dataclass
class GroupStats:
    """Per-region group-comparison (level test) statistics block
    (reference: tombo/tombo_helper.py:318-328 ``groupStats``)."""
    reg_stats: np.ndarray
    reg_poss: np.ndarray
    chrm: str
    strand: str
    start: int
    reg_cov: np.ndarray
    ctrl_cov: np.ndarray
