from .bert import (BertConfig, BertForPretraining,
                   BertForSequenceClassification, BertModel,
                   BertPretrainingCriterion, ErnieConfig,
                   ErnieForSequenceClassification, ErnieModel, bert_base,
                   bert_large, bert_tiny)
from .convert import state_dict_from_numpy
from .gpt import (GPT, GPTBlock, GPTConfig, GPTPretrainingCriterion,
                  gpt_125m, gpt_1p3b, gpt_350m, gpt_760m, gpt_tiny,
                  init_state_dict)

__all__ = ["GPT", "GPTBlock", "GPTConfig", "GPTPretrainingCriterion",
           "init_state_dict", "state_dict_from_numpy", "gpt_tiny",
           "gpt_125m", "gpt_350m", "gpt_760m", "gpt_1p3b", "BertConfig",
           "BertModel", "BertForPretraining", "BertForSequenceClassification",
           "BertPretrainingCriterion", "ErnieConfig", "ErnieModel",
           "ErnieForSequenceClassification", "bert_tiny", "bert_base",
           "bert_large"]
