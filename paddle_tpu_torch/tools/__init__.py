"""The operator's tools over the port's telemetry: ``doctor.py``,
``telemetry_dump.py``, ``postmortem.py`` and ``perfwatch.py``.
Counterparts of the reference's top-level ``tools/`` scripts.

Each is a script run by path (``python paddle_tpu_torch/tools/doctor.py
<run_dir>``): it loads ``paddle_tpu_torch/observability/{aggregate,doctor,
baseline}.py`` by path and imports no torch, so it also runs on a machine
without it. Imported as package modules they only define their functions.
"""
