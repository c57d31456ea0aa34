from semicp.utils.metrics import MetricsLogger, PhaseTimer  # noqa: F401
