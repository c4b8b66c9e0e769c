"""One reader per per-layer metric, `<metric>.py` with `read(trace)`: the
metric's value from the traced window, or None where it finds nothing to
read (the harness then leaves the metric out)."""
