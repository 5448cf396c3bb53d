from sdtpu_torch.diffusion.ddim import ddim_alphas, ddim_schedule, ddim_step  # noqa: F401
from sdtpu_torch.diffusion.schedule import (  # noqa: F401
    offset_cosine_schedule_cumprod,
    scaled_linear_alphas_cumprod,
)
