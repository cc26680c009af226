"""Typed runtime configuration of the port: the knobs its main path reads.

The JAX package's config (`kzg_tpu/config.py`) also carries the Mosaic
kernel-shape knobs, the NTT, eval-form and mesh settings; none of those is
read by this slice, so none is copied.

Usage:
    from kzg_tpu_torch.config import get_config, configure
    configure(msm_window=12)
"""

from dataclasses import dataclass, replace, fields as _dc_fields


@dataclass(frozen=True)
class KZGConfig:
    # Pippenger window; None = size heuristic (msm.pippenger.effective_window)
    msm_window: int | None = None
    # below this point count a batched double-and-add ladder replaces the
    # bucket method (msm.pippenger._msm_small)
    small_msm_threshold: int = 512
    # SRS construction engine; only the native host engine is ported
    setup_engine: str = "host"
    # "auto"/"host": native C++ pairing engine (oracle if it is missing);
    # "oracle": the pure-Python pairing
    pairing_engine: str = "auto"

    def validate(self):
        if self.pairing_engine not in ("auto", "host", "oracle"):
            raise ValueError(f"bad pairing_engine {self.pairing_engine!r}")
        if self.setup_engine != "host":
            raise ValueError(f"bad setup_engine {self.setup_engine!r}: only 'host'")
        if self.msm_window is not None and not (1 <= self.msm_window <= 16):
            raise ValueError("msm_window must be in [1, 16]")
        if self.small_msm_threshold < 1:
            raise ValueError("small_msm_threshold must be >= 1")
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
