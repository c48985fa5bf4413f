"""The JAX references of ``tests/test_torch_tp_moe.py`` for one mesh, run
in a spawned process of its own, so that the meshes' references compile
side by side. ``run(world, payload, out_path)`` pickles what
``test_torch_tp_moe._jax_refs`` returns to ``out_path``."""
import os
import pickle


def run(world, payload, out_path):
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               "--xla_backend_optimization_level=0")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import test_torch_tp_moe as T
    with T._no_cache_writes():
        refs = T._jax_refs(world, payload)
    with open(out_path + ".part", "wb") as f:
        pickle.dump(refs, f)
    os.replace(out_path + ".part", out_path)
