"""Batched re-squiggle (:mod:`.batch`), its per-read host helpers
(:mod:`.resquiggle`) and the reference aligner (:mod:`.aligner`)."""
