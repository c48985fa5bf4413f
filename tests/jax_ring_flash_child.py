"""The JAX package's ``ring_flash_attention`` (its Pallas flash kernel in
interpret mode, under ``shard_map`` over ``sp`` on 4 virtual CPU devices)
run in a spawned process of its own, so that its interpret-mode kernels
and shard_map's CPU collectives do not share a process with the rest of
a test run. ``run(cases, out_path)`` writes each case's (out, dq, dk, dv)
to an ``.npz``; the caller spawns it and reads the file."""
import os


def run(cases, out_path):
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_backend_optimization_level=0")
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["PADDLE_TPU_PALLAS_INTERPRET"] = "1"
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    jax.config.update("jax_platforms", "cpu")

    from paddle_tpu.parallel import ring
    from paddle_tpu.utils.jax_compat import shard_map

    mesh = Mesh(np.array(jax.devices()[:4]), ("sp",))
    spec = P(None, "sp")
    out = {}
    for c in cases:
        fn = shard_map(functools.partial(ring.ring_flash_attention,
                                         axis_name="sp", causal=c["causal"]),
                       mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                       check_vma=False)

        def both(q, k, v, go):
            o, vjp = jax.vjp(fn, q, k, v)
            return (o,) + vjp(go)
        res = jax.jit(both)(*(jnp.asarray(a) for a in c["qkvg"]))
        for name, a in zip(("out", "dq", "dk", "dv"), res):
            out[f"{c['name']}/{name}"] = np.asarray(a)
    np.savez(out_path, **out)
