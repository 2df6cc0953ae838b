"""Read-sharded execution over several devices (:mod:`.mesh`) and the
host helpers that divide reads among hosts and merge their sums
(:mod:`.distributed`)."""
