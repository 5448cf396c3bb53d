from sdtpu_torch.diffusion.ddim import ddim_alphas, ddim_schedule, ddim_step  # noqa: F401
from sdtpu_torch.diffusion.schedule import scaled_linear_alphas_cumprod  # noqa: F401
