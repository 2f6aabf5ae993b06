import torch

from uig_torch.config.config import remat_mode
from uig_torch.models.layers import (InstanceNorm, PadConv, ResnetBlock,
                                     UpsampleConv)
from uig_torch.models.patch_disc import PatchDiscriminator
from uig_torch.models.resnet_gen import ResNetGenerator
from uig_torch.models.vqgan import VQGANGenerator


# the kinds the port runs in bf16; the ResNet generator serves all but vqgan
BF16_KINDS = ("cyclegan", "vqgan", "cut", "dclgan")
RESNET_KINDS = ("cyclegan", "cut", "dclgan")


def model_dtype(model_cfg, dtype_field: str) -> torch.dtype:
    """The torch dtype of ``model_cfg.<dtype_field>`` (``eval_dtype`` for
    serving, ``compute_dtype`` for training): float32 always; bfloat16 for
    the kinds in ``BF16_KINDS``, in training and in serving."""
    name = getattr(model_cfg, dtype_field)
    if name == "float32":
        return torch.float32
    if name == "bfloat16" and model_cfg.kind in BF16_KINDS:
        return torch.bfloat16
    if name == "bfloat16":
        why = (f"kind={model_cfg.kind!r} runs in float32 only (ROADMAP: "
               f"{model_cfg.kind} in bf16)")
    else:
        why = "the port runs float32 and bfloat16"
    raise NotImplementedError(
        f"model.{dtype_field}={name!r}: {why}; pass "
        f"model.{dtype_field}=float32")


def generator_from_config(model_cfg, dtype_field: str = "eval_dtype"):
    """The generator of a ``ModelConfig``, by ``model.kind``: the ResNet
    generator for ``cyclegan``, ``cut`` and ``dclgan``, ``VQGANGenerator``
    for ``vqgan``, in the
    dtype of ``model.<dtype_field>`` (``model_dtype``): serving reads
    ``model.eval_dtype``, training ``model.compute_dtype``."""
    dtype = model_dtype(model_cfg, dtype_field)
    m = model_cfg
    if m.kind in RESNET_KINDS:
        return ResNetGenerator(
            out_channels=m.out_channels, base_features=m.g_base_features,
            n_res_blocks=m.n_res_blocks, norm=m.norm, pad_mode=m.padding,
            upsample=m.upsample, resample=m.resample,
            in_channels=m.in_channels, dtype=dtype)
    if m.kind == "vqgan":
        if remat_mode(m.remat) != "none":
            raise NotImplementedError(
                f"model.remat={m.remat!r}: rematerialization is not ported "
                "yet; set model.remat=none")
        return VQGANGenerator(
            base_features=m.vq_base_features, channel_mults=m.vq_channel_mults,
            embed_dim=m.vq_embed_dim, codebook_size=m.vq_codebook_size,
            out_channels=m.out_channels,
            attn_resolutions=m.vq_attn_resolutions, resolution=m.image_size,
            in_channels=m.in_channels, dtype=dtype)
    raise NotImplementedError(
        f"model.kind={m.kind!r}: the port has {', '.join(RESNET_KINDS)} "
        "and vqgan only")


__all__ = [
    "InstanceNorm",
    "PadConv",
    "PatchDiscriminator",
    "ResNetGenerator",
    "ResnetBlock",
    "UpsampleConv",
    "VQGANGenerator",
    "generator_from_config",
    "model_dtype",
]
