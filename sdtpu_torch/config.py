"""Model configurations of the port (a copy of sdtpu/config.py's dataclasses
and presets).

The fields and defaults are sdtpu's, so a configuration means the same
model on both sides; tests/test_torch_config.py holds every preset equal to
sdtpu's, field by field. A resolution is the same object with another
`image_size`, e.g. `dataclasses.replace(SD_V1_4, image_size=1024)`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """CLIP text transformer."""

    n_vocab: int = 49408
    n_state: int = 768
    n_head: int = 12
    n_ctx: int = 77
    n_layer: int = 12
    layer_norm_eps: float = 1e-5
    # QuickGELU (x * sigmoid(1.702 x)) for SD v1 CLIP; OpenCLIP ViT-H (SD v2)
    # uses exact GELU
    quick_gelu: bool = True
    # SD v2 uses the penultimate hidden layer; 0 = the final layer (v1)
    skip_last_layers: int = 0


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """SD v1 UNet denoiser; the down/up paths derive from channel_mult and
    n_res_blocks as in the original LDM config."""

    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    n_res_blocks: int = 2
    # levels (by index) with a SpatialTransformer after each ResBlock
    attention_levels: Tuple[int, ...] = (0, 1, 2)
    n_head: int = 8
    # SD v2 fixes head_dim=64; when set, n_head is channels // head_dim
    head_dim: Optional[int] = None
    context_dim: int = 768
    time_embed_dim: int = 1280  # model_channels * 4
    max_period: int = 10000
    groupnorm_groups: int = 32
    groupnorm_eps: float = 1e-5
    ln_eps: float = 1e-5

    def heads_for(self, channels: int) -> int:
        if self.head_dim is not None:
            return channels // self.head_dim
        return self.n_head


@dataclasses.dataclass(frozen=True)
class AutoencoderConfig:
    """KL autoencoder f=8; (in, out) channels per encoder/decoder level."""

    in_channels: int = 3
    latent_channels: int = 4
    encoder_channels: Tuple[Tuple[int, int], ...] = (
        (128, 128),
        (128, 256),
        (256, 512),
        (512, 512),
    )
    decoder_channels: Tuple[Tuple[int, int], ...] = (
        (512, 512),
        (512, 512),
        (512, 256),
        (256, 128),
    )
    groupnorm_groups: int = 32
    groupnorm_eps: float = 1e-6  # the ldm VAE's
    # encode keeps the first 4 of 8 quant channels (the means; no sampling)
    double_z: bool = True


@dataclasses.dataclass(frozen=True)
class StableDiffusionConfig:
    """Whole-pipeline configuration."""

    clip: CLIPConfig = dataclasses.field(default_factory=CLIPConfig)
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    vae: AutoencoderConfig = dataclasses.field(default_factory=AutoencoderConfig)
    n_train_steps: int = 1000  # alphas_cumprod table length
    latent_scale: float = 0.18215
    image_size: int = 512
    # epsilon (SD v1/v2-base) or v (SD v2.1-768) prediction target
    prediction_type: str = "epsilon"
    name: str = "sd-v1-4"

    @property
    def vae_factor(self) -> int:
        """Spatial scale factor: one stride-2 stage per VAE level except the
        last (f=8 for SD's 4-level VAE)."""
        return 2 ** (len(self.vae.decoder_channels) - 1)

    @property
    def latent_size(self) -> int:
        return self.image_size // self.vae_factor


SD_V1_4 = StableDiffusionConfig(name="sd-v1-4")

SD_V1_5 = StableDiffusionConfig(name="sd-v1-5")  # identical architecture

SD_V2_1 = StableDiffusionConfig(
    name="sd-v2-1",
    clip=CLIPConfig(
        n_vocab=49408,
        n_state=1024,
        n_head=16,
        n_ctx=77,
        n_layer=23,  # penultimate layer of the 24-layer ViT-H text tower
        quick_gelu=False,
    ),
    unet=UNetConfig(context_dim=1024, head_dim=64),
    image_size=768,
    prediction_type="v",
)

# scaled-down architecture for tests (SD v1's topology with 2 levels)
SD_TINY = StableDiffusionConfig(
    name="sd-tiny",
    clip=CLIPConfig(n_vocab=49408, n_state=32, n_head=4, n_ctx=77, n_layer=2),
    unet=UNetConfig(
        model_channels=16,
        channel_mult=(1, 2),
        attention_levels=(0,),
        n_head=4,
        context_dim=32,
        time_embed_dim=64,
        groupnorm_groups=4,
    ),
    vae=AutoencoderConfig(
        encoder_channels=((8, 8), (8, 16)),
        decoder_channels=((16, 16), (16, 8)),
        groupnorm_groups=4,
    ),
    image_size=32,
)

PRESETS = {
    "sd-v1-4": SD_V1_4,
    "sd-v1-5": SD_V1_5,
    "sd-v2-1": SD_V2_1,
    "sd-tiny": SD_TINY,
}


def config_to_dict(cfg: StableDiffusionConfig) -> dict:
    """JSON-serialisable dict (io/native.py embeds it in a model's metadata,
    so a configuration that is no preset round-trips)."""
    return dataclasses.asdict(cfg)


def config_from_dict(d: dict) -> StableDiffusionConfig:
    """Inverse of config_to_dict. Unknown fields raise: a model written by a
    newer version must not load silently mis-configured."""
    u = dict(d["unet"])
    u["channel_mult"] = tuple(u["channel_mult"])
    u["attention_levels"] = tuple(u["attention_levels"])
    v = dict(d["vae"])
    v["encoder_channels"] = tuple(tuple(p) for p in v["encoder_channels"])
    v["decoder_channels"] = tuple(tuple(p) for p in v["decoder_channels"])
    rest = {k: val for k, val in d.items() if k not in ("clip", "unet", "vae")}
    return StableDiffusionConfig(
        clip=CLIPConfig(**d["clip"]),
        unet=UNetConfig(**u),
        vae=AutoencoderConfig(**v),
        **rest,
    )
