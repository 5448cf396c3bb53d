from sdtpu_torch.ops.activations import silu, quick_gelu, gelu, geglu  # noqa: F401
from sdtpu_torch.ops.attention import qkv_attention, causal_mask  # noqa: F401
from sdtpu_torch.ops.groupnorm import group_norm, layer_norm  # noqa: F401
from sdtpu_torch.ops.conv import conv2d, linear, embedding  # noqa: F401
from sdtpu_torch.ops.timestep import timestep_embedding  # noqa: F401
