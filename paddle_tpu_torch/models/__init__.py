from .convert import state_dict_from_numpy
from .gpt import (GPTConfig, gpt_125m, gpt_1p3b, gpt_350m, gpt_760m,
                  gpt_tiny, init_state_dict)

__all__ = ["GPTConfig", "init_state_dict", "state_dict_from_numpy",
           "gpt_tiny", "gpt_125m", "gpt_350m", "gpt_760m", "gpt_1p3b"]
