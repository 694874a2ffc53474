from .bert import (BertConfig, BertForPretraining,
                   BertForSequenceClassification, BertModel,
                   BertPretrainingCriterion, ErnieConfig,
                   ErnieForSequenceClassification, ErnieModel, bert_base,
                   bert_large, bert_tiny)
from .convert import state_dict_from_numpy, trainer_state_from_numpy
from .generation import beam_search, generate
from .gpt import (GPT, GPTBlock, GPTConfig, GPTPretrainingCriterion,
                  gpt_125m, gpt_1p3b, gpt_350m, gpt_760m, gpt_tiny,
                  init_state_dict)
from .moe import GPTMoE, MoEConfig, MoEMLP, gpt_moe_small, gpt_moe_tiny
from .moe_gate import GShardGate, NaiveTopKGate, SwitchGate, make_gate

__all__ = ["GPT", "GPTBlock", "GPTConfig", "GPTPretrainingCriterion",
           "init_state_dict", "state_dict_from_numpy",
           "trainer_state_from_numpy", "generate", "beam_search", "gpt_tiny",
           "gpt_125m", "gpt_350m", "gpt_760m", "gpt_1p3b", "BertConfig",
           "BertModel", "BertForPretraining", "BertForSequenceClassification",
           "BertPretrainingCriterion", "ErnieConfig", "ErnieModel",
           "ErnieForSequenceClassification", "bert_tiny", "bert_base",
           "bert_large", "MoEConfig", "MoEMLP", "GPTMoE", "gpt_moe_tiny",
           "gpt_moe_small", "NaiveTopKGate", "SwitchGate", "GShardGate",
           "make_gate"]
