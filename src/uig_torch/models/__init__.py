from uig_torch.config.config import remat_mode
from uig_torch.models.layers import (InstanceNorm, PadConv, ResnetBlock,
                                     UpsampleConv)
from uig_torch.models.patch_disc import PatchDiscriminator
from uig_torch.models.resnet_gen import ResNetGenerator
from uig_torch.models.vqgan import VQGANGenerator


def check_float32(model_cfg, dtype_field: str) -> None:
    """Raise unless ``model_cfg.<dtype_field>`` (``eval_dtype`` for serving,
    ``compute_dtype`` for training) is float32: bf16 is on the ROADMAP."""
    dtype = getattr(model_cfg, dtype_field)
    if dtype != "float32":
        raise NotImplementedError(
            f"model.{dtype_field}={dtype!r}: the port runs float32 only "
            f"(bf16 is on the ROADMAP); pass model.{dtype_field}=float32")


def generator_from_config(model_cfg, dtype_field: str = "eval_dtype"):
    """The fp32 generator of a ``ModelConfig``, by ``model.kind``: the
    ResNet generator for ``cyclegan``, ``VQGANGenerator`` for ``vqgan``.
    Serving checks ``model.eval_dtype``, training ``model.compute_dtype``."""
    check_float32(model_cfg, dtype_field)
    m = model_cfg
    if m.kind == "cyclegan":
        return ResNetGenerator(
            out_channels=m.out_channels, base_features=m.g_base_features,
            n_res_blocks=m.n_res_blocks, norm=m.norm, pad_mode=m.padding,
            upsample=m.upsample, resample=m.resample,
            in_channels=m.in_channels)
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
            in_channels=m.in_channels)
    raise NotImplementedError(
        f"model.kind={m.kind!r}: the port has cyclegan and vqgan only")


__all__ = [
    "InstanceNorm",
    "PadConv",
    "PatchDiscriminator",
    "ResNetGenerator",
    "ResnetBlock",
    "UpsampleConv",
    "VQGANGenerator",
    "check_float32",
    "generator_from_config",
]
