"""Modified-base detection on one host or several: the per-read tests,
the alternative-model test, the level tests and per-read statistics
through the device lane (``detect.iter_region_stats``); model
estimation."""
