"""Training listeners and the full-batch Solver algorithms."""
from .listeners import (
    CheckpointListener, CollectScoresIterationListener, IterationListener,
    NanScoreWatcher, ParamAndGradientIterationListener, PerformanceListener,
    ProfilerListener, ScoreIterationListener, TimeIterationListener,
    TrainingListener)

__all__ = ["CheckpointListener", "CollectScoresIterationListener",
           "IterationListener", "NanScoreWatcher",
           "ParamAndGradientIterationListener", "PerformanceListener",
           "ProfilerListener", "ScoreIterationListener",
           "TimeIterationListener", "TrainingListener"]
