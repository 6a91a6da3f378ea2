from .trace import RunLog, device_stage, set_run_log, stage  # noqa: F401
