"""The port's operator CLIs (``[project.scripts]`` in pyproject.toml): the
port of ``horovod_tpu/tools``, standard library only, reading the files
and views the port's telemetry writes (a JAX gang's too: the formats are
the same).

- ``hvd-top-torch`` (hvd_top.py): live terminal dashboard over the gang
  aggregator's ``/gang/metrics.json`` view.
- ``hvd-trace-torch`` (hvd_trace.py): merge/analyze/diff gang-wide span
  traces.
- ``hvd-postmortem-torch`` (hvd_postmortem.py): gang-correlated verdict
  over flight-recorder dumps.
"""
