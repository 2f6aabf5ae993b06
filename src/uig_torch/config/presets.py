"""Named presets: the port's copy of the JAX package's preset table (same
names, same values)."""
from __future__ import annotations

import dataclasses

from uig_torch.config.config import (
    Config,
    DataConfig,
    EvalConfig,
    LossConfig,
    ModelConfig,
    OptConfig,
    ParallelConfig,
    RunConfig,
)


def _smoke64() -> Config:
    return Config(
        model=ModelConfig(
            kind="cyclegan",
            image_size=64,
            n_res_blocks=6,
            d_layers=3,
            compute_dtype="float32",
        ),
        loss=LossConfig(gan_mode="lsgan"),
        opt=OptConfig(total_steps=2000, decay_start_step=1000, pool_size=50),
        data=DataConfig(
            source="synthetic",
            load_size=72,
            batch_size=1,
            augment="xla",
            synthetic_len=200,
        ),
        run=RunConfig(name="smoke64", log_every=10, ckpt_every=200),
    )


def _smalldata64() -> Config:
    """Small-dataset recipe: TTUR, R1 and resize_conv upsampling."""
    return Config(
        model=ModelConfig(
            kind="cyclegan",
            image_size=64,
            n_res_blocks=6,
            d_layers=3,
            upsample="resize_conv",
        ),
        loss=LossConfig(gan_mode="lsgan", r1_gamma=0.05),
        opt=OptConfig(total_steps=5000, decay_start_step=2500,
                      d_lr_ratio=0.5, pool_size=50),
        data=DataConfig(
            source="synthetic",
            load_size=72,
            batch_size=8,
            augment="pallas",
            synthetic_len=200,
        ),
        eval=EvalConfig(fid_every=250, fid_num_samples=200),
        run=RunConfig(name="smalldata64", log_every=100, ckpt_every=1000),
    )


def _cyclegan128() -> Config:
    return Config(
        model=ModelConfig(kind="cyclegan", image_size=128, n_res_blocks=6,
                          head_s2d=4, stem_dx_s2d=4, fused_applies=True),
        loss=LossConfig(gan_mode="lsgan"),
        opt=OptConfig(total_steps=100_000, decay_start_step=50_000),
        data=DataConfig(load_size=143, batch_size=1, augment="pallas"),
        run=RunConfig(name="cyclegan128"),
    )


def _cyclegan256_dp() -> Config:
    return Config(
        model=ModelConfig(kind="cyclegan", image_size=256, n_res_blocks=9,
                          head_s2d=4, stem_dx_s2d=4, fused_applies=True),
        loss=LossConfig(gan_mode="lsgan", lambda_lpips=1.0),
        opt=OptConfig(total_steps=200_000, decay_start_step=100_000),
        data=DataConfig(load_size=286, batch_size=8, augment="pallas"),
        parallel=ParallelConfig(num_devices=0),
        run=RunConfig(name="cyclegan256_dp"),
    )


def _cut256_multihost() -> Config:
    return Config(
        model=ModelConfig(kind="cut", image_size=256, n_res_blocks=9,
                          head_s2d=4),
        loss=LossConfig(gan_mode="lsgan", lambda_cycle=0.0, lambda_identity=0.0,
                        lambda_nce=1.0),
        opt=OptConfig(total_steps=200_000, decay_start_step=100_000),
        data=DataConfig(load_size=286, batch_size=16, augment="pallas"),
        parallel=ParallelConfig(num_devices=0, multihost=True),
        run=RunConfig(name="cut256_multihost"),
    )


def _fastcut256() -> Config:
    return Config(
        model=ModelConfig(kind="cut", image_size=256, n_res_blocks=9,
                          head_s2d=4),
        loss=LossConfig(gan_mode="lsgan", lambda_cycle=0.0,
                        lambda_identity=0.0, lambda_nce=10.0,
                        nce_include_identity=False,
                        nce_flip_equivariance=True),
        opt=OptConfig(total_steps=200_000, decay_start_step=100_000),
        data=DataConfig(load_size=286, batch_size=16, augment="pallas"),
        parallel=ParallelConfig(num_devices=0),
        run=RunConfig(name="fastcut256"),
    )


def _dclgan256() -> Config:
    return Config(
        model=ModelConfig(kind="dclgan", image_size=256, n_res_blocks=9,
                          head_s2d=4),
        loss=LossConfig(gan_mode="lsgan", lambda_cycle=0.0,
                        lambda_identity=1.0, lambda_nce=2.0),
        opt=OptConfig(total_steps=200_000, decay_start_step=100_000),
        data=DataConfig(load_size=286, batch_size=16, augment="pallas"),
        parallel=ParallelConfig(num_devices=0),
        run=RunConfig(name="dclgan256"),
    )


def _gcgan256() -> Config:
    return Config(
        model=ModelConfig(kind="gcgan", image_size=256, n_res_blocks=9,
                          gc_transform="rot90", head_s2d=4),
        loss=LossConfig(gan_mode="lsgan", lambda_cycle=0.0,
                        lambda_identity=0.0, lambda_gc=10.0),
        opt=OptConfig(total_steps=200_000, decay_start_step=100_000),
        data=DataConfig(load_size=286, batch_size=16, augment="pallas"),
        parallel=ParallelConfig(num_devices=0),
        run=RunConfig(name="gcgan256"),
    )


def _discogan64() -> Config:
    return Config(
        model=ModelConfig(kind="cyclegan", image_size=64, n_res_blocks=6,
                          d_layers=3),
        loss=LossConfig(gan_mode="vanilla", lambda_cycle=10.0,
                        lambda_identity=0.0),
        opt=OptConfig(total_steps=100_000, decay_start_step=50_000),
        data=DataConfig(load_size=72, batch_size=8, augment="pallas"),
        run=RunConfig(name="discogan64"),
    )


def _unit256() -> Config:
    return Config(
        model=ModelConfig(kind="unit", image_size=256,
                          stem_dx_s2d=4,
                          unit_private_res=2, unit_shared_res=2),
        loss=LossConfig(gan_mode="lsgan", lambda_cycle=10.0,
                        lambda_unit_kl=0.01),
        opt=OptConfig(lr=1e-4, total_steps=200_000, decay_start_step=100_000),
        data=DataConfig(load_size=286, batch_size=8, augment="pallas"),
        parallel=ParallelConfig(num_devices=0),
        run=RunConfig(name="unit256"),
    )


def _munit256() -> Config:
    return Config(
        model=ModelConfig(kind="munit", image_size=256,
                          stem_dx_s2d=4,
                          munit_style_dim=8, munit_content_res=4,
                          munit_mlp_dim=256, d_num_scales=3, d_norm="none",
                          d_layers=4),
        loss=LossConfig(gan_mode="lsgan", lambda_cycle=10.0,
                        lambda_munit_c=1.0, lambda_munit_s=1.0,
                        lambda_munit_cyc=0.0),
        opt=OptConfig(lr=1e-4, total_steps=200_000, decay_start_step=100_000),
        data=DataConfig(load_size=286, batch_size=8, augment="pallas"),
        parallel=ParallelConfig(num_devices=0),
        run=RunConfig(name="munit256"),
    )


def _stargan128() -> Config:
    return Config(
        model=ModelConfig(kind="stargan", image_size=128, num_domains=3,
                          stem_dx_s2d=4,
                          n_res_blocks=6, d_layers=6),
        loss=LossConfig(gan_mode="wgan", lambda_cycle=10.0, lambda_cls=1.0,
                        lambda_gp=10.0, lambda_identity=0.0),
        opt=OptConfig(lr=1e-4, total_steps=200_000, decay_start_step=100_000,
                      d_steps_per_g=5),
        data=DataConfig(load_size=143, batch_size=12, augment="pallas"),
        parallel=ParallelConfig(num_devices=0),
        run=RunConfig(name="stargan128"),
    )


def _starganv2_256() -> Config:
    return Config(
        model=ModelConfig(kind="starganv2", image_size=256, num_domains=3,
                          v2_style_dim=64, v2_latent_dim=16,
                          v2_max_features=512),
        loss=LossConfig(gan_mode="vanilla", r1_gamma=1.0, lambda_sty=1.0,
                        lambda_ds=2.0, ds_decay_steps=100_000,
                        lambda_cycle=1.0, lambda_identity=0.0),
        opt=OptConfig(lr=1e-4, b1=0.0, b2=0.99, weight_decay=1e-4,
                      f_lr_ratio=0.01, ema_decay=0.999,
                      total_steps=100_000, decay_start_step=100_000),
        data=DataConfig(load_size=286, batch_size=8, augment="pallas"),
        parallel=ParallelConfig(num_devices=0),
        run=RunConfig(name="starganv2_256"),
    )


def _ugatit256() -> Config:
    return Config(
        model=ModelConfig(kind="ugatit", image_size=256, n_res_blocks=4,
                          stem_dx_s2d=4,
                          ugatit_d_global_layers=7, ugatit_d_local_layers=5),
        loss=LossConfig(gan_mode="lsgan", lambda_cycle=10.0,
                        lambda_identity=1.0, lambda_cam=1000.0),
        opt=OptConfig(lr=1e-4, weight_decay=1e-4, total_steps=200_000,
                      decay_start_step=100_000),
        data=DataConfig(load_size=286, batch_size=8, augment="pallas"),
        parallel=ParallelConfig(num_devices=0),
        run=RunConfig(name="ugatit256"),
    )


def _nicegan256() -> Config:
    return Config(
        model=ModelConfig(kind="nicegan", image_size=256, n_res_blocks=6),
        loss=LossConfig(gan_mode="lsgan", lambda_cycle=10.0,
                        lambda_recon=10.0),
        opt=OptConfig(lr=1e-4, weight_decay=1e-4, total_steps=100_000,
                      decay_start_step=50_000),
        data=DataConfig(load_size=286, batch_size=8, augment="pallas"),
        parallel=ParallelConfig(num_devices=0),
        run=RunConfig(name="nicegan256"),
    )


def _vaegan256() -> Config:
    return Config(
        model=ModelConfig(
            kind="vaegan",
            image_size=256,
            vq_base_features=64,
            vq_channel_mults=(1, 2, 2, 4),
            vq_embed_dim=64,
            vq_attn_resolutions=(32,),
            vq_beta=1e-2,
            attn_impl="pallas",
        ),
        loss=LossConfig(gan_mode="hinge", lambda_vq_adv=0.5, vq_disc_start=5_000),
        opt=OptConfig(lr=1e-4, b1=0.5, b2=0.9, total_steps=300_000,
                      decay_start_step=150_000),
        data=DataConfig(load_size=286, batch_size=16, augment="pallas"),
        parallel=ParallelConfig(num_devices=0, multihost=True),
        run=RunConfig(name="vaegan256"),
    )


def _vqgan512() -> Config:
    return Config(
        model=ModelConfig(
            kind="vqgan",
            image_size=512,
            vq_base_features=128,
            vq_channel_mults=(1, 1, 2, 2, 4),
            vq_attn_resolutions=(32,),
            attn_impl="pallas",
        ),
        loss=LossConfig(gan_mode="hinge", lambda_vq_adv=0.8,
                        vq_disc_start=10_000, vq_adaptive_weight=True),
        opt=OptConfig(lr=4.5e-6, b1=0.5, b2=0.9, total_steps=500_000,
                      decay_start_step=500_000),
        data=DataConfig(load_size=512, batch_size=4, augment="pallas"),
        run=RunConfig(name="vqgan512"),
    )


PRESETS = {
    "smoke64": _smoke64,
    "smalldata64": _smalldata64,
    "cyclegan128": _cyclegan128,
    "cyclegan256_dp": _cyclegan256_dp,
    "cut256_multihost": _cut256_multihost,
    "fastcut256": _fastcut256,
    "dclgan256": _dclgan256,
    "gcgan256": _gcgan256,
    "unit256": _unit256,
    "munit256": _munit256,
    "stargan128": _stargan128,
    "starganv2_256": _starganv2_256,
    "ugatit256": _ugatit256,
    "nicegan256": _nicegan256,
    "discogan64": _discogan64,
    "vaegan256": _vaegan256,
    "vqgan512": _vqgan512,
}


def get_preset(name: str, **replacements) -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    cfg = PRESETS[name]()
    if replacements:
        cfg = dataclasses.replace(cfg, **replacements)
    return cfg
