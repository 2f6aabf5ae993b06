"""Typed dataclass config tree with dotted-path overrides.

The port's own copy of the JAX package's config dataclasses (same fields,
same defaults, same dict round-trip), so a JAX run's ``config.json`` loads
unchanged without importing the JAX package. ``apply_overrides`` takes
``["opt.lr=1e-4"]``-style dotted overrides.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any


@dataclass(frozen=True)
class ModelConfig:
    """Generator/discriminator architecture knobs."""

    kind: str = "cyclegan"
    image_size: int = 256
    in_channels: int = 3
    out_channels: int = 3
    g_base_features: int = 64
    n_res_blocks: int = 9
    upsample: str = "conv_transpose"
    resample: str = "strided"
    norm: str = "instance"
    padding: str = "reflect"
    pad_impl: str = "fused"
    d_base_features: int = 64
    d_layers: int = 3
    compute_dtype: str = "bfloat16"
    eval_dtype: str = "float32"
    remat: str = "none"
    conv_impl: str = "xla"
    convin_pallas: bool = False
    head_s2d: int = 0
    stem_s2d: int = 0
    stem_dx_s2d: int = 0
    down_s2d: int = 0
    fused_applies: bool = False
    vq_embed_dim: int = 256
    vq_codebook_size: int = 1024
    vq_channel_mults: tuple[int, ...] = (1, 1, 2, 2, 4)
    vq_base_features: int = 128
    vq_attn_resolutions: tuple[int, ...] = (32,)
    vq_beta: float = 0.25
    attn_impl: str = "pallas"
    prior_dim: int = 512
    prior_depth: int = 8
    prior_heads: int = 8
    prior_style: str = "ar"
    prior_sample_steps: int = 12
    prior_choice_temp: float = 4.5
    prior_vqgan_run: str = ""
    unit_private_res: int = 2
    unit_shared_res: int = 2
    munit_style_dim: int = 8
    munit_content_res: int = 4
    munit_mlp_dim: int = 256
    d_num_scales: int = 3
    d_norm: str = "none"
    num_domains: int = 3
    v2_style_dim: int = 64
    v2_latent_dim: int = 16
    v2_max_features: int = 512
    ugatit_d_global_layers: int = 7
    ugatit_d_local_layers: int = 5
    nce_layers: tuple[int, ...] = (0, 4, 8, 12, 16)
    nce_patches: int = 256
    nce_proj_dim: int = 256
    gc_transform: str = "rot90"


@dataclass(frozen=True)
class LossConfig:
    gan_mode: str = "lsgan"
    lambda_cycle: float = 10.0
    lambda_identity: float = 0.5
    lambda_lpips: float = 0.0
    lambda_nce: float = 1.0
    nce_temperature: float = 0.07
    nce_include_identity: bool = True
    nce_flip_equivariance: bool = False
    lambda_unit_kl: float = 0.01
    lambda_munit_c: float = 1.0
    lambda_munit_s: float = 1.0
    lambda_munit_cyc: float = 0.0
    lambda_vq_adv: float = 1.0
    vq_disc_start: int = 0
    vq_adaptive_weight: bool = False
    lambda_cls: float = 1.0
    lambda_gp: float = 10.0
    lambda_sty: float = 1.0
    lambda_ds: float = 1.0
    ds_decay_steps: int = 100_000
    lambda_cam: float = 1000.0
    lambda_gc: float = 10.0
    lambda_recon: float = 10.0
    r1_gamma: float = 0.0
    ada_target: float = 0.0
    ada_p_init: float = 0.0
    ada_speed_kimg: float = 500.0
    ada_ops: str = "color,translation,cutout"


@dataclass(frozen=True)
class OptConfig:
    optimizer: str = "adam"
    lr: float = 2e-4
    b1: float = 0.5
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0
    total_steps: int = 200_000
    decay_start_step: int = 100_000
    lr_decay: str = "linear"
    warmup_steps: int = 0
    ema_decay: float = 0.999
    grad_accum: int = 1
    pool_size: int = 50
    d_lr_ratio: float = 1.0
    f_lr_ratio: float = 0.01
    d_steps_per_g: int = 1


@dataclass(frozen=True)
class DataConfig:
    source: str = "synthetic"
    dir_a: str = ""
    dir_b: str = ""
    domain_dirs: tuple[str, ...] = ()
    load_size: int = 286
    batch_size: int = 1
    shuffle_seed: int = 0
    num_workers: int = 4
    prefetch: int = 2
    producer_threads: int = 1
    augment: str = "pallas"
    synthetic_len: int = 200


@dataclass(frozen=True)
class ParallelConfig:
    data_axis: str = "data"
    num_devices: int = 0
    multihost: bool = False


@dataclass(frozen=True)
class EvalConfig:
    fid_num_samples: int = 500
    fid_features: str = "auto"
    inception_weights: str = ""
    vgg_weights: str = ""
    lpips_lin_weights: str = ""
    fid_every: int = 0
    fid_batch_size: int = 16
    sample_grid_every: int = 1000
    sample_grid_n: int = 4


@dataclass(frozen=True)
class RunConfig:
    name: str = "run"
    workdir: str = "/tmp/uig_runs"
    log_every: int = 50
    ckpt_every: int = 1000
    ckpt_keep: int = 3
    seed: int = 0
    steps_per_dispatch: int = 1
    n_critic_fuse: bool = False
    profile_steps: tuple[int, int] = (0, 0)
    tensorboard: bool = False
    debug_nans: bool = False
    check_tracer_leaks: bool = False


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    opt: OptConfig = field(default_factory=OptConfig)
    data: DataConfig = field(default_factory=DataConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    run: RunConfig = field(default_factory=RunConfig)


# ---------------------------------------------------------------------------
# dict round-trip + dotted-path overrides
# ---------------------------------------------------------------------------


def config_to_dict(cfg: Any) -> dict:
    """Recursively convert a (nested) dataclass to plain JSON-able dicts."""
    out = {}
    for f in fields(cfg):
        v = getattr(cfg, f.name)
        if is_dataclass(v):
            out[f.name] = config_to_dict(v)
        elif isinstance(v, tuple):
            out[f.name] = list(v)
        else:
            out[f.name] = v
    return out


def config_from_dict(d: dict, cls: type = Config) -> Any:
    """Inverse of config_to_dict (unknown keys rejected loudly)."""
    kwargs = {}
    field_map = {f.name: f for f in fields(cls)}
    for k, v in d.items():
        if k not in field_map:
            raise KeyError(f"unknown config field {cls.__name__}.{k}")
        f = field_map[k]
        if is_dataclass(f.type) if isinstance(f.type, type) else False:
            kwargs[k] = config_from_dict(v, f.type)
        elif isinstance(v, dict):
            sub = _resolve_dataclass(cls, f.name)
            kwargs[k] = config_from_dict(v, sub)
        elif isinstance(v, list):
            kwargs[k] = tuple(v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


def _resolve_dataclass(cls: type, name: str) -> type:
    for f in fields(cls):
        if f.name == name:
            t = f.type
            if isinstance(t, str):
                t = globals()[t]
            return t
    raise KeyError(name)


def _coerce(old: Any, raw: str) -> Any:
    """Coerce a CLI string to the type of the existing value."""
    if isinstance(old, bool):
        if raw.lower() in ("1", "true", "yes"):
            return True
        if raw.lower() in ("0", "false", "no"):
            return False
        raise ValueError(f"cannot parse bool from {raw!r}")
    if isinstance(old, int) and not isinstance(old, bool):
        return int(raw)
    if isinstance(old, float):
        return float(raw)
    if isinstance(old, tuple):
        parts = [p for p in raw.strip("()[] ").split(",") if p != ""]
        if old:
            elem_t = type(old[0])
        else:
            def elem_t(p):
                for t in (int, float):
                    try:
                        return t(p)
                    except ValueError:
                        pass
                return p
        return tuple(elem_t(p) for p in parts)
    return raw


def apply_overrides(cfg: Config, overrides: dict[str, str] | list[str]) -> Config:
    """Apply ``{"opt.lr": "1e-4"}`` or ``["opt.lr=1e-4"]`` style overrides."""
    if isinstance(overrides, list):
        pairs = {}
        for item in overrides:
            if "=" not in item:
                raise ValueError(f"override {item!r} is not key=value")
            k, v = item.split("=", 1)
            pairs[k.lstrip("-")] = v
        overrides = pairs
    for path, raw in overrides.items():
        parts = path.split(".")
        cfg = _replace_path(cfg, parts, raw)
    return cfg


def _replace_path(node: Any, parts: list[str], raw: str) -> Any:
    head = parts[0]
    if not hasattr(node, head):
        raise KeyError(f"no config field {head!r} on {type(node).__name__}")
    cur = getattr(node, head)
    if len(parts) == 1:
        new = raw if not isinstance(raw, str) else _coerce(cur, raw)
        return dataclasses.replace(node, **{head: new})
    return dataclasses.replace(node, **{head: _replace_path(cur, parts[1:], raw)})


def dump_config(cfg: Config, path: str) -> None:
    with open(path, "w") as f:
        json.dump(config_to_dict(cfg), f, indent=2, sort_keys=True)


def load_config(path: str) -> Config:
    with open(path) as f:
        return config_from_dict(json.load(f))


def remat_mode(value) -> str:
    """Normalize ModelConfig.remat: bools and their string forms are legacy
    for full/none; returns one of none | full | blocks."""
    if isinstance(value, bool):
        return "full" if value else "none"
    v = str(value).lower()
    if v in ("true", "1", "yes"):
        return "full"
    if v in ("false", "0", "no", ""):
        return "none"
    if v not in ("none", "full", "blocks"):
        raise ValueError(f"model.remat must be none|full|blocks, got {value!r}")
    return v
