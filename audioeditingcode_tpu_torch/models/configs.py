"""Model specs of the port: the AudioLDM, AudioLDM2 and TANGO mel UNets,
Stable Audio Open and the image models.

The port's own copies of every ``audioeditingcode_tpu/models/configs.py``
entry: the audio models (AudioLDM-s and -l, AudioLDM2, -large and -music,
both TANGO checkpoints, Stable Audio Open 1.0), the image models (Stable
Diffusion v1.4 with its CLIP text tower, the CelebA-HQ LDM with its VQ
autoencoder) and their tiny test configs (``test/tiny-audioldm``,
``test/tiny-audioldm2``, ``test/tiny-tango``, ``test/tiny-stable-audio``,
``test/tiny-sd``, ``test/tiny-celebahq``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..ops.stft import MelConfig
from ..schedulers.cosine_dpm import CosineDPMConfig
from ..schedulers.ddim import DDIMConfig
from .dit1d import DiT1DConfig
from .hifigan import HifiGanConfig
from .oobleck import OobleckConfig
from .projection import ProjectionConfig
from .unet2d import UNet2DConditionConfig
from .vae import AutoencoderKLConfig


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    """AudioLDM2's GPT-2 language model (embeddings in, hidden states out)."""

    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    n_positions: int = 1024
    layer_norm_epsilon: float = 1e-5


@dataclasses.dataclass(frozen=True)
class AudioLDM2ProjectionConfig:
    text_encoder_dim: int = 512  # CLAP
    text_encoder_1_dim: int = 1024  # FLAN-T5
    langauge_model_dim: int = 768  # (sic: diffusers' field spelling)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    model_id: str
    family: str  # 'audioldm' | 'audioldm2' | 'tango' | 'stable-audio' | 'stable-diffusion' | 'celebahq'
    unet: Optional[UNet2DConditionConfig]
    vae: Optional[AutoencoderKLConfig]
    vocoder: Optional[HifiGanConfig]
    scheduler: DDIMConfig
    mel: Optional[MelConfig]
    sample_rate: int = 16000
    text_encoder: str = "clap"  # 'clap' | 't5' | 'clap+t5+gpt2' | 'clip' (with a checkpoint) | 'null' | 'none'
    text_embed_dim: int = 512
    text_seq_len: int = 1
    recommended_steps: int = 200
    # Stable Audio family (1-D waveform path):
    dit: Optional[DiT1DConfig] = None
    oobleck: Optional[OobleckConfig] = None
    cosine_scheduler: Optional[CosineDPMConfig] = None
    projection: Optional[ProjectionConfig] = None
    # AudioLDM2 language-model chain (None: the full-size defaults)
    gpt2: Optional[GPT2Config] = None
    projection_lm: Optional[AudioLDM2ProjectionConfig] = None


_AUDIOLDM_SCHED = DDIMConfig(
    num_train_timesteps=1000, beta_start=0.0015, beta_end=0.0195,
    beta_schedule="scaled_linear", prediction_type="epsilon",
    set_alpha_to_one=False, steps_offset=1,
)
_SD_SCHED = DDIMConfig(
    num_train_timesteps=1000, beta_start=0.00085, beta_end=0.012,
    beta_schedule="scaled_linear", prediction_type="epsilon",
    set_alpha_to_one=False, steps_offset=1,
)
_SD21_V_SCHED = dataclasses.replace(_SD_SCHED, prediction_type="v_prediction")

_MEL_16K = MelConfig(
    filter_length=1024, hop_length=160, win_length=1024,
    n_mel_channels=64, sampling_rate=16000, mel_fmin=0.0, mel_fmax=8000.0,
)

_HIFIGAN_16K_64 = HifiGanConfig(
    model_in_dim=64, upsample_initial_channel=1024,
    upsample_rates=(5, 4, 2, 2, 2), upsample_kernel_sizes=(16, 16, 8, 4, 4),
    resblock_kernel_sizes=(3, 7, 11),
    resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
    sampling_rate=16000, normalize_before=False,
)

_AUDIOLDM_VAE = AutoencoderKLConfig(
    in_channels=1, out_channels=1, latent_channels=8,
    block_out_channels=(128, 256, 512), layers_per_block=2,
    scaling_factor=0.9227914,
)



def _audioldm_unet(block_out, heads=8) -> UNet2DConditionConfig:
    return UNet2DConditionConfig(
        in_channels=8, out_channels=8,
        down_block_types=("CrossAttnDownBlock2D",) * 3 + ("DownBlock2D",),
        up_block_types=("UpBlock2D",) + ("CrossAttnUpBlock2D",) * 3,
        block_out_channels=block_out,
        layers_per_block=2,
        cross_attention_dim=None,  # attn2 degrades to self-attn (FiLM-only text)
        num_attention_heads=heads,
        class_embed_type="simple_projection",
        projection_class_embeddings_input_dim=512,
        class_embeddings_concat=True,
    )


def _audioldm2_unet(block_out, cross_dim, heads=8) -> UNet2DConditionConfig:
    return UNet2DConditionConfig(
        in_channels=8, out_channels=8,
        down_block_types=("CrossAttnDownBlock2D",) * 3 + ("DownBlock2D",),
        up_block_types=("UpBlock2D",) + ("CrossAttnUpBlock2D",) * 3,
        block_out_channels=block_out,
        layers_per_block=2,
        cross_attention_dim=cross_dim,  # GPT-2 generated embeds
        double_cross_attention=True,
        cross_attention_dim_1=1024,  # T5/CLAP projected stream
        num_attention_heads=heads,
        use_linear_projection=True,
    )


def _tango_unet() -> UNet2DConditionConfig:
    return UNet2DConditionConfig(
        in_channels=8, out_channels=8,
        down_block_types=("CrossAttnDownBlock2D",) * 3 + ("DownBlock2D",),
        up_block_types=("UpBlock2D",) + ("CrossAttnUpBlock2D",) * 3,
        block_out_channels=(320, 640, 1280, 1280),
        layers_per_block=2, cross_attention_dim=1024,
        num_attention_heads=8, use_linear_projection=True,
    )


TINY_UNET = UNet2DConditionConfig(
    in_channels=4, out_channels=4,
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    block_out_channels=(32, 64),
    layers_per_block=1, norm_num_groups=8,
    cross_attention_dim=None, num_attention_heads=4,
    class_embed_type="simple_projection",
    projection_class_embeddings_input_dim=32,
    class_embeddings_concat=True,
)

TINY_VAE = AutoencoderKLConfig(
    in_channels=1, out_channels=1, latent_channels=4,
    block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8,
    scaling_factor=0.5,
)

TINY_HIFIGAN = HifiGanConfig(
    model_in_dim=64, upsample_initial_channel=32,
    upsample_rates=(5, 4, 2, 2, 2), upsample_kernel_sizes=(16, 16, 8, 4, 4),
    resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
)

MODEL_SPECS = {
    "cvssp/audioldm-s-full-v2": ModelSpec(
        model_id="cvssp/audioldm-s-full-v2", family="audioldm",
        unet=_audioldm_unet((128, 256, 384, 640)),
        vae=_AUDIOLDM_VAE, vocoder=_HIFIGAN_16K_64,
        scheduler=_AUDIOLDM_SCHED, mel=_MEL_16K,
        text_encoder="clap", text_embed_dim=512, recommended_steps=100,
    ),
    "cvssp/audioldm-l-full": ModelSpec(
        model_id="cvssp/audioldm-l-full", family="audioldm",
        unet=_audioldm_unet((256, 512, 768, 1280)),
        vae=_AUDIOLDM_VAE, vocoder=_HIFIGAN_16K_64,
        scheduler=_AUDIOLDM_SCHED, mel=_MEL_16K,
        text_encoder="clap", text_embed_dim=512, recommended_steps=100,
    ),
    "cvssp/audioldm2": ModelSpec(
        model_id="cvssp/audioldm2", family="audioldm2",
        unet=_audioldm2_unet((128, 256, 384, 640), cross_dim=768),
        vae=_AUDIOLDM_VAE, vocoder=_HIFIGAN_16K_64,
        scheduler=_AUDIOLDM_SCHED, mel=_MEL_16K,
        text_encoder="clap+t5+gpt2", text_embed_dim=768, text_seq_len=8,
    ),
    "cvssp/audioldm2-large": ModelSpec(
        model_id="cvssp/audioldm2-large", family="audioldm2",
        unet=_audioldm2_unet((256, 384, 640, 1024), cross_dim=768),
        vae=_AUDIOLDM_VAE, vocoder=_HIFIGAN_16K_64,
        scheduler=_AUDIOLDM_SCHED, mel=_MEL_16K,
        text_encoder="clap+t5+gpt2", text_embed_dim=768, text_seq_len=8,
    ),
    "cvssp/audioldm2-music": ModelSpec(
        model_id="cvssp/audioldm2-music", family="audioldm2",
        unet=_audioldm2_unet((128, 256, 384, 640), cross_dim=768),
        vae=_AUDIOLDM_VAE, vocoder=_HIFIGAN_16K_64,
        scheduler=_AUDIOLDM_SCHED, mel=_MEL_16K,
        text_encoder="clap+t5+gpt2", text_embed_dim=768, text_seq_len=8,
    ),
    "declare-lab/tango-full-ft-audio-music-caps": ModelSpec(
        model_id="declare-lab/tango-full-ft-audio-music-caps", family="tango",
        unet=_tango_unet(),
        vae=_AUDIOLDM_VAE, vocoder=_HIFIGAN_16K_64,
        scheduler=_SD21_V_SCHED, mel=_MEL_16K,
        text_encoder="t5", text_embed_dim=1024, text_seq_len=512,
    ),
    "declare-lab/tango-full-ft-audiocaps": ModelSpec(
        model_id="declare-lab/tango-full-ft-audiocaps", family="tango",
        unet=_tango_unet(),
        vae=_AUDIOLDM_VAE, vocoder=_HIFIGAN_16K_64,
        scheduler=_SD21_V_SCHED, mel=_MEL_16K,
        text_encoder="t5", text_embed_dim=1024, text_seq_len=512,
    ),
    "stabilityai/stable-audio-open-1.0": ModelSpec(
        model_id="stabilityai/stable-audio-open-1.0", family="stable-audio",
        unet=None, vae=None, vocoder=None,
        scheduler=_AUDIOLDM_SCHED,  # unused; the cosine solver drives this family
        mel=None, sample_rate=44100,
        text_encoder="t5", text_embed_dim=768, text_seq_len=128,
        recommended_steps=100,
        dit=DiT1DConfig(),
        oobleck=OobleckConfig(),
        cosine_scheduler=CosineDPMConfig(),
        projection=ProjectionConfig(),
    ),
    "test/tiny-stable-audio": ModelSpec(
        model_id="test/tiny-stable-audio", family="stable-audio",
        unet=None, vae=None, vocoder=None,
        scheduler=_AUDIOLDM_SCHED, mel=None, sample_rate=4000,
        text_encoder="null", text_embed_dim=32, text_seq_len=4,
        recommended_steps=8,
        dit=DiT1DConfig(
            sample_size=16, in_channels=4, out_channels=4, num_layers=2,
            attention_head_dim=16, num_attention_heads=4,
            num_key_value_attention_heads=2, cross_attention_dim=32,
            cross_attention_input_dim=32, global_states_input_dim=64,
            time_proj_dim=32,
        ),
        oobleck=OobleckConfig(
            encoder_hidden_size=8, downsampling_ratios=(2, 2),
            channel_multiples=(1, 2), decoder_channels=8,
            decoder_input_channels=4, audio_channels=2, sampling_rate=4000,
        ),
        cosine_scheduler=CosineDPMConfig(),
        projection=ProjectionConfig(text_encoder_dim=32, conditioning_dim=32, internal_dim=16),
    ),
    "test/tiny-audioldm": ModelSpec(
        model_id="test/tiny-audioldm", family="audioldm",
        unet=TINY_UNET, vae=TINY_VAE, vocoder=TINY_HIFIGAN,
        scheduler=_AUDIOLDM_SCHED, mel=_MEL_16K,
        text_encoder="null", text_embed_dim=32, recommended_steps=20,
    ),
    "test/tiny-audioldm2": ModelSpec(
        model_id="test/tiny-audioldm2", family="audioldm2",
        unet=UNet2DConditionConfig(
            in_channels=4, out_channels=4,
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
            block_out_channels=(32, 64), layers_per_block=1, norm_num_groups=8,
            cross_attention_dim=24, double_cross_attention=True,
            cross_attention_dim_1=40, num_attention_heads=4,
            use_linear_projection=True,
        ),
        vae=TINY_VAE, vocoder=TINY_HIFIGAN,
        scheduler=_AUDIOLDM_SCHED, mel=_MEL_16K,
        text_encoder="null", text_embed_dim=24, text_seq_len=6,
        recommended_steps=8,
        gpt2=GPT2Config(n_embd=24, n_layer=2, n_head=2, n_positions=64),
        projection_lm=AudioLDM2ProjectionConfig(
            text_encoder_dim=16, text_encoder_1_dim=40, langauge_model_dim=24,
        ),
    ),
    "test/tiny-tango": ModelSpec(
        model_id="test/tiny-tango", family="tango",
        unet=UNet2DConditionConfig(
            in_channels=4, out_channels=4,
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
            block_out_channels=(32, 64), layers_per_block=1, norm_num_groups=8,
            cross_attention_dim=32, num_attention_heads=4,
            use_linear_projection=True,
        ),
        vae=TINY_VAE, vocoder=TINY_HIFIGAN,
        scheduler=_SD21_V_SCHED, mel=_MEL_16K,
        text_encoder="t5", text_embed_dim=32, text_seq_len=16,
        recommended_steps=8,
    ),
    "CompVis/stable-diffusion-v1-4": ModelSpec(
        model_id="CompVis/stable-diffusion-v1-4", family="stable-diffusion",
        unet=UNet2DConditionConfig(
            in_channels=4, out_channels=4,
            down_block_types=("CrossAttnDownBlock2D",) * 3 + ("DownBlock2D",),
            up_block_types=("UpBlock2D",) + ("CrossAttnUpBlock2D",) * 3,
            block_out_channels=(320, 640, 1280, 1280),
            layers_per_block=2, cross_attention_dim=768,
            num_attention_heads=8,
        ),
        vae=AutoencoderKLConfig(
            in_channels=3, out_channels=3, latent_channels=4,
            block_out_channels=(128, 256, 512, 512), layers_per_block=2,
            scaling_factor=0.18215,
        ),
        vocoder=None, scheduler=_SD_SCHED, mel=None,
        text_encoder="clip", text_embed_dim=768, text_seq_len=77,
        recommended_steps=100,
    ),
    "CompVis/ldm-celebahq-256": ModelSpec(
        model_id="CompVis/ldm-celebahq-256", family="celebahq",
        unet=UNet2DConditionConfig(
            in_channels=3, out_channels=3,
            down_block_types=("DownBlock2D",) * 4,
            up_block_types=("UpBlock2D",) * 4,
            block_out_channels=(224, 448, 672, 896),
            layers_per_block=2, cross_attention_dim=None,
            num_attention_heads=8, mid_block_type=None,
        ),
        vae=AutoencoderKLConfig(
            in_channels=3, out_channels=3, latent_channels=3,
            block_out_channels=(128, 256, 512), layers_per_block=2,
            scaling_factor=1.0, double_z=False, num_vq_embeddings=8192,
        ),
        vocoder=None, scheduler=_AUDIOLDM_SCHED, mel=None,
        text_encoder="none", recommended_steps=100,
    ),
    "test/tiny-sd": ModelSpec(
        model_id="test/tiny-sd", family="stable-diffusion",
        unet=UNet2DConditionConfig(
            in_channels=4, out_channels=4,
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
            block_out_channels=(32, 64), layers_per_block=1, norm_num_groups=8,
            cross_attention_dim=32, num_attention_heads=4,
        ),
        vae=AutoencoderKLConfig(
            in_channels=3, out_channels=3, latent_channels=4,
            block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8,
            scaling_factor=0.18215,
        ),
        vocoder=None, scheduler=_SD_SCHED, mel=None,
        text_encoder="clip", text_embed_dim=32, text_seq_len=8,
        recommended_steps=10,
    ),
    "test/tiny-celebahq": ModelSpec(
        model_id="test/tiny-celebahq", family="celebahq",
        unet=UNet2DConditionConfig(
            in_channels=3, out_channels=3,
            down_block_types=("DownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "UpBlock2D"),
            block_out_channels=(32, 64), layers_per_block=1, norm_num_groups=8,
            cross_attention_dim=None, num_attention_heads=4, mid_block_type=None,
        ),
        vae=AutoencoderKLConfig(
            in_channels=3, out_channels=3, latent_channels=3,
            block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8,
            scaling_factor=1.0, double_z=False, num_vq_embeddings=32,
        ),
        vocoder=None, scheduler=_AUDIOLDM_SCHED, mel=None,
        text_encoder="none", recommended_steps=10,
    ),
}
