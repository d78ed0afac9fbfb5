"""Samplers for the diffusion tail."""

from ttts_tpu_torch.diffusion.dpm import cfg_eps_fn, dpm_solver_pp_2m_sample  # noqa: F401


def get_ode_sampler(name: str):
    """Continuous-time ODE sampler by name (DiffusionProcessConfig.sampler).
    UniPC is not ported yet."""
    if name in ("dpm++2m", "dpmsolver"):
        return dpm_solver_pp_2m_sample
    raise NotImplementedError(f"ODE sampler {name!r} is not ported")
