"""paddle_tpu_torch.incubate.moe (counterpart of
`paddle_tpu/incubate/moe.py`; reference
`incubate/distributed/models/moe`): a flat namespace over the dispatch
(`models/moe.py`), the gate policies (`models/moe_gate.py`) and the
MoE-aware global-norm clip (`nn/clip.py`)."""
from ..models.moe import GPTMoE, MoEConfig, MoEMLP
from ..models.moe_gate import GShardGate, NaiveTopKGate, SwitchGate, make_gate
from ..nn.clip import ClipGradForMOEByGlobalNorm

__all__ = ["MoEConfig", "MoEMLP", "GPTMoE", "NaiveTopKGate", "SwitchGate",
           "GShardGate", "make_gate", "ClipGradForMOEByGlobalNorm"]
