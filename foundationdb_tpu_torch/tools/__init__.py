"""Operator tools of the port: ``fdbserver`` (the server process),
``cli`` (fdbcli), ``backup`` (backup agents and restore), ``doctor`` (the
health watchdog), ``tracing`` (the span reader), ``flight`` (the
flight-recorder reader), ``heatmap`` (split-point advice),
``benchdiff`` (bench-round differ) and ``faultcov`` (the fault-coverage
reporter and its seeded chaos probe). The readers that attach to a
served cluster (``doctor --connect``, ``flight --connect``, ``heatmap
--cluster-file``) and ``faultcov --snapshot`` are clients and never
import ``torch``."""
