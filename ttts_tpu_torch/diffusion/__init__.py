"""Samplers for the diffusion tail."""

import functools

from ttts_tpu_torch.diffusion.dpm import cfg_eps_fn, dpm_solver_pp_2m_sample  # noqa: F401
from ttts_tpu_torch.diffusion.unipc import uni_pc_sample  # noqa: F401


def get_ode_sampler(name: str):
    """Continuous-time ODE sampler by name (DiffusionProcessConfig.sampler),
    as ttts_tpu.diffusion.get_ode_sampler: each takes (eps_fn, noise,
    steps=...)."""
    if name in ("dpm++2m", "dpmsolver"):
        return dpm_solver_pp_2m_sample
    if name in ("unipc", "unipc_bh2"):
        return uni_pc_sample
    if name == "unipc_bh1":
        return functools.partial(uni_pc_sample, variant="bh1")
    raise NotImplementedError(f"unknown ODE sampler {name!r}")
