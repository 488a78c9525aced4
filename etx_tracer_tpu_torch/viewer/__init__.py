"""Interactive web viewer (`server.py`), counterpart of `etx_tracer_tpu/viewer`."""
