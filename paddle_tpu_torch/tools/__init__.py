"""The port's report tools (counterparts of ``tools/trace_report.py``,
``trace_export.py``, ``obs_report.py`` and ``fleet_dash.py``): the same
command lines and outputs over the port's own dumps, importing
``paddle_tpu_torch`` only. Each runs as ``python -m
paddle_tpu_torch.tools.<name>``."""
