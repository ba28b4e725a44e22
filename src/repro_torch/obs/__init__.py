"""Observability of the port (twin of ``repro/obs``): the structured
telemetry sink and the step's hooks (:mod:`repro_torch.obs.telemetry`), the
Perfetto trace merge (:mod:`repro_torch.obs.trace`) and the report CLI.

Host-side artifacts:

  * ``events-p{N}.jsonl`` — one JSON object per line, per process.
  * ``trace.json`` — Chrome/Perfetto trace merged across processes
    (:mod:`repro_torch.obs.trace`), pid = process index, tid = event lane.
  * ``python -m repro_torch.obs.report <dir>`` — phase breakdown, collective
    timeline, solve-convergence summary.
"""
from . import telemetry, trace  # noqa: F401
