"""Training and inference engines, optimization methods, schedules,
regularizers, triggers and validation methods."""

from .fused import FusedLayout, fuse, fused_update, plan, unfuse
from .metrics import Metrics
from .method import (EMA, LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax,
                     OptimMethod, RMSprop)
from .optimizer import (ConfigurationError, DistriOptimizer,
                        DistriValidator, Evaluator, LocalOptimizer,
                        LocalValidator, NonFiniteLossError, Optimizer,
                        PeerLostError, Predictor, StallError,
                        TrainingPreempted, Validator)
from .regularizer import (L1L2Regularizer, L1Regularizer, L2Regularizer,
                          Regularizer)
from .schedules import (CosineDecay, Default, EpochDecay, EpochSchedule,
                        EpochStep, Exponential, LearningRateSchedule,
                        MultiStep, NaturalExp, Plateau, Poly, Regime,
                        SequentialSchedule, Step, Warmup)
from .trigger import Trigger
from .validation import (MAE, NDCG, AccuracyResult, HitRatio, Loss,
                         LossResult, Perplexity, PerplexityResult,
                         Top1Accuracy, Top5Accuracy, TreeNNAccuracy,
                         ValidationMethod, ValidationResult)

__all__ = ["Optimizer", "DistriOptimizer", "LocalOptimizer", "Predictor", "Evaluator", "Validator",
           "DistriValidator", "LocalValidator", "NonFiniteLossError",
           "ConfigurationError", "TrainingPreempted", "StallError",
           "PeerLostError", "OptimMethod", "SGD",
           "Adam", "Adagrad", "Adadelta", "Adamax", "RMSprop", "LBFGS",
           "EMA", "LearningRateSchedule", "Default", "Poly", "Step",
           "MultiStep", "EpochDecay", "EpochStep", "NaturalExp",
           "Exponential", "EpochSchedule", "Regime", "Plateau",
           "SequentialSchedule", "Warmup", "CosineDecay", "Regularizer",
           "L1Regularizer", "L2Regularizer", "L1L2Regularizer", "Trigger",
           "ValidationMethod", "ValidationResult", "AccuracyResult",
           "LossResult", "PerplexityResult", "Top1Accuracy", "Top5Accuracy",
           "Loss", "Perplexity", "MAE", "HitRatio", "NDCG", "TreeNNAccuracy",
           "FusedLayout", "plan", "fuse", "unfuse", "fused_update", "Metrics"]
