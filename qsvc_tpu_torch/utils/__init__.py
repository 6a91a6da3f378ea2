from .trace import RunLog, set_run_log, stage  # noqa: F401
