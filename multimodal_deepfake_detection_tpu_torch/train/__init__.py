"""Training machinery (counterpart of ``multimodal_deepfake_detection_tpu/train/``)."""
from .loop import EpochResult, TrainLoop
from .optim import Optimizer, get_learning_rate, make_optimizer, set_learning_rate
from .schedules import PlateauScheduler, onecycle_schedule
from .state import EmaState, TrainState, ema_init, ema_update
