"""Typed runtime configuration of the port: the knobs its main path reads.

The JAX package's config (`kzg_tpu/config.py`) also carries the Mosaic
kernel-shape knobs, the MSM A/B variants, the streamed-division chunk and
the mesh settings; none of those is read by the port yet, so none is copied.
No environment variable is read.

`device` is the port's own: the ONE place that decides where a constructor
puts its tensors when the caller names no device (`resolve_device`). It
defaults to the card; a host without one gets torch's error, never a quiet
run of the plain twins on the CPU. CPU runs ask for it:
`configure(device="cpu")` or `device="cpu"` at the call.

Usage:
    from kzg_tpu_torch.config import get_config, configure
    configure(msm_window=12)
"""

from dataclasses import dataclass, replace, fields as _dc_fields


@dataclass(frozen=True)
class KZGConfig:
    # where constructors place tensors when the caller passes device=None
    # (setup, KZGParams / LagrangeSRS loaders, Polynomial.from_ints, the
    # *_to_device converters, LimbField.zeros / one): see resolve_device
    device: str = "cuda"
    # Pippenger window; None = size heuristic (msm.pippenger.effective_window)
    msm_window: int | None = None
    # bucket-loop steps fused into one launch of kernel K7 (madd_multi) by
    # the MSMs whose windows have fewer than 1024 buckets
    msm_fuse_steps: int = 16
    # below this point count a batched double-and-add ladder replaces the
    # bucket method (msm.pippenger._msm_small)
    small_msm_threshold: int = 512
    # MSM / SRS-ladder chunk: above 2^this points setup_device builds the G1
    # ladder in chunks of 2^this powers (flat peak memory); MSMs themselves
    # are not chunked yet
    msm_chunk_log: int = 22
    # fixed-base window of the device SRS ladders (table = 2^w per window)
    fixed_base_window: int = 8
    # SRS construction engine. "auto": the device ladders when the resolved
    # device is a card, the native host engine on the CPU; "host" / "device"
    # force one (kzg.srs.host_engine_preferred). "device" with a CPU device
    # runs the ladders on the plain twins: the tests' route
    setup_engine: str = "auto"
    # directory of the fixed-base table cache (None: the repo's .srs_cache)
    srs_cache_dir: str | None = None
    # "auto"/"host": native C++ pairing engine (oracle if it is missing);
    # "oracle": the pure-Python pairing
    pairing_engine: str = "auto"
    # domains of size >= 2^this use the four-step (Bailey) NTT
    # (ntt.domain.Domain._ntt_four_step); tests lower it to reach that path
    ntt_four_step_min_exp: int = 16
    # matmul-DFT blocks in the NTT (ntt/mxu.py): "off" = butterfly stages
    # (K5) everywhere; "auto" = on for tensors on a card, off on the CPU;
    # "force" = on everywhere (CPU tensors then run the plain versions of
    # the product and of kernel K9: the tests' route)
    ntt_mxu: str = "off"
    # quotient length above which long division switches from the
    # schoolbook loop to Newton-inverse division (poly.newton)
    newton_div_threshold: int = 32
    # point count at which SubProductTree.eval_points switches from direct
    # evaluation to the remainder tree
    tree_eval_threshold: int = 64
    # window of the digit ladder (CurveOps.scalar_mul_digits) behind the
    # group iNTT of the Lagrange-SRS construction (kzg.eval_form): a table
    # of 2^c - 1 multiples per lane, ceil(255 / c) rounds of c doublings
    # and one madd
    group_ladder_window: int = 4

    def validate(self):
        if self.pairing_engine not in ("auto", "host", "oracle"):
            raise ValueError(f"bad pairing_engine {self.pairing_engine!r}")
        if self.setup_engine not in ("auto", "host", "device"):
            raise ValueError(f"bad setup_engine {self.setup_engine!r}")
        if not (2 <= self.fixed_base_window <= 16):
            raise ValueError("fixed_base_window must be in [2, 16]")
        if self.msm_chunk_log < 4:
            raise ValueError("msm_chunk_log must be >= 4")
        if self.ntt_mxu not in ("auto", "off", "force"):
            raise ValueError(f"bad ntt_mxu {self.ntt_mxu!r}")
        if self.msm_window is not None and not (1 <= self.msm_window <= 16):
            raise ValueError("msm_window must be in [1, 16]")
        if not (1 <= self.msm_fuse_steps <= 256):
            raise ValueError("msm_fuse_steps must be in [1, 256]")
        if self.small_msm_threshold < 1:
            raise ValueError("small_msm_threshold must be >= 1")
        if self.ntt_four_step_min_exp < 2:
            raise ValueError("ntt_four_step_min_exp must be >= 2")
        if self.newton_div_threshold < 0 or self.tree_eval_threshold < 1:
            raise ValueError("newton_div_threshold must be >= 0, tree_eval_threshold >= 1")
        if not (1 <= self.group_ladder_window <= 8):
            raise ValueError("group_ladder_window must be in [1, 8]")
        return self


_config = KZGConfig().validate()


def get_config() -> KZGConfig:
    return _config


def set_config(cfg: KZGConfig) -> KZGConfig:
    global _config
    _config = cfg.validate()
    return _config


def configure(**kwargs) -> KZGConfig:
    """Update selected fields of the global config (returns the new one)."""
    bad = set(kwargs) - {f.name for f in _dc_fields(KZGConfig)}
    if bad:
        raise TypeError(f"unknown config fields: {sorted(bad)}")
    return set_config(replace(_config, **kwargs))


def resolve_device(device=None):
    """The torch device a constructor uses: the caller's, else the
    configured default. Creating a tensor on a default "cuda" where there is
    no card raises (torch's own error)."""
    import torch

    return torch.device(_config.device if device is None else device)
