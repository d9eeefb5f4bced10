"""One reader per per-layer metric: ``<metric>.py`` with ``read(run)``,
which returns the metric's value from a ``harness.Run``, or None when the
run holds nothing for it to read (the harness then leaves the metric out
of the result line)."""
