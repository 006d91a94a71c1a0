"""One reader per metric: ``<metric name>.py`` holds ``read(ctx)``, which
returns the metric's value from a run, or None where the run has nothing
for it to read. ``_read.py`` holds what the readers share."""
