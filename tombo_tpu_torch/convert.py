"""Build the port's inputs from plain numpy arrays, strings and numbers.

This system has no weights: what crosses from a caller (or from the JAX
package, in the parity tests) is the k-mer model table, the re-squiggle
parameters and the mapped reads.  Each function here takes plain values
(``dataclasses.asdict`` of the JAX records gives exactly such a dict) and
returns the port's own record, so both packages can be fed identical
inputs without this package importing anything of the other."""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

from .config import ResquiggleParams
from .io.model_io import AltModel, KmerModel
from .seq import TomboMotif
from .types import (AlignInfo, GenomeLocation, ResquiggleResults,
                    ScaleValues, SeqSampleType)


def kmer_model(means, sds, central_pos: int, name: str = "standard",
               seq_samp_type: Optional[str] = None) -> KmerModel:
    return KmerModel(np.array(means, np.float64), np.array(sds, np.float64),
                     int(central_pos), str(name), seq_samp_type)


def alt_model(means, sds, central_pos: int, alt_base: str, name: str,
              raw_motif: str, mod_pos: int) -> AltModel:
    return AltModel(np.array(means, np.float64), np.array(sds, np.float64),
                    int(central_pos), str(alt_base), str(name),
                    TomboMotif(str(raw_motif), int(mod_pos)))


def resquiggle_params(fields: Mapping) -> ResquiggleParams:
    """Every field of :class:`ResquiggleParams`, by name."""
    return ResquiggleParams(**{
        f: fields[f] for f in ResquiggleParams.__dataclass_fields__})


def seq_samp_type(name: str, rev_sig: bool) -> SeqSampleType:
    return SeqSampleType(str(name), bool(rev_sig))


def scale_values(fields: Optional[Mapping]) -> Optional[ScaleValues]:
    if fields is None:
        return None
    return ScaleValues(**{
        f: fields.get(f) for f in ScaleValues.__dataclass_fields__})


def resquiggle_results(fields: Mapping) -> ResquiggleResults:
    """A mapped read from a dict of plain values; nested records are
    dicts too, arrays are numpy arrays, unknown keys are ignored."""
    ai = fields.get("align_info")
    gl = fields.get("genome_loc")
    raw = fields.get("raw_signal")
    segs = fields.get("segs")
    stalls = fields.get("stall_ints")
    return ResquiggleResults(
        align_info=None if ai is None else AlignInfo(**{
            f: ai[f] for f in AlignInfo.__dataclass_fields__}),
        genome_loc=None if gl is None else GenomeLocation(
            int(gl["start"]), str(gl["strand"]), str(gl["chrom"])),
        genome_seq=fields.get("genome_seq"),
        mean_q_score=fields.get("mean_q_score"),
        raw_signal=None if raw is None else np.array(raw),
        read_start_rel_to_raw=fields.get("read_start_rel_to_raw"),
        segs=None if segs is None else np.array(segs),
        scale_values=scale_values(fields.get("scale_values")),
        sig_match_score=fields.get("sig_match_score"),
        norm_params_changed=fields.get("norm_params_changed"),
        start_clip_bases=fields.get("start_clip_bases"),
        stall_ints=None if stalls is None else [
            (int(a), int(b)) for a, b in stalls])
