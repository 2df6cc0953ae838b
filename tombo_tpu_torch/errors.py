"""Per-read error of the port (counterpart of ``tombo_tpu.errors``).

Every recoverable per-read failure raises :class:`TomboError` with a
short stable message that doubles as the failure-mode key, so one bad
read never ends a batch."""


class TomboError(Exception):
    """Recoverable, per-read error (the read is skipped and reported)."""
