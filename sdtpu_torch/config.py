"""Model configurations of the port: sdtpu's, re-exported.

`sdtpu.config` is pure Python (dataclasses and presets, no jax), so the
port uses the same objects and a configuration means the same model on
both sides. Callers of the port import them from here.
"""

from sdtpu.config import (  # noqa: F401
    PRESETS,
    SD_TINY,
    SD_V1_4,
    SD_V1_5,
    SD_V2_1,
    AutoencoderConfig,
    CLIPConfig,
    StableDiffusionConfig,
    UNetConfig,
)
