"""Modified-base detection: the de novo and model-sample-compare tests
through the packed device lane (``detect.iter_region_stats``)."""
