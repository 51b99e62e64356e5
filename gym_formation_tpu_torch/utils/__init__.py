from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .config import from_dict, load_config, save_config, to_dict
from .logging import MetricsLogger

__all__ = ["MetricsLogger", "from_dict", "latest_step", "load_config", "restore_checkpoint",
           "save_checkpoint", "save_config", "to_dict"]
