#!/usr/bin/env python3
"""How far int8 W8A8 serving drifts from f32, layer by layer, in the JAX
package and in the port, on the same weights (CPU; both packages).

    JAX_PLATFORMS=cpu python tools/torch_int8_drift.py [--entry data2vec_large_ll60k]

The JAX registry's entry is built with its random weights (f32); the same
weights go to the port (`trunk_state_dict_from_jax`). On B=2 x 0.5 s (the
batch of tests/test_quant.py:553-591) it prints the per-layer cosine over
the valid frames against the JAX f32 states of: the port's f32 model, the
JAX int8 model (its plain route: int8 projections around the stock
attention, the only one XLA runs on the CPU), and the port's int8 model on
its plain route and on its kernel route (the kernels' plain versions); then
the port's own seed-0 model, int8 on both routes against its f32 model
(the weights `chip_smoke.py` loads). A deep post-LN model (data2vec-Large:
24 layers) drifts below the JAX package's 0.999 int8 gate, which its tests
set for HuBERT-Large and HuBERT-Base (tests/test_quant.py:82-124, :553-583).
"""

import argparse
import dataclasses
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--entry", default="data2vec_large_ll60k")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import s3prl_tpu_torch.models.transformer as port_transformer
    from s3prl_tpu.upstream import registry as jax_registry
    from s3prl_tpu_torch import hub
    from s3prl_tpu_torch.upstream.convert import trunk_state_dict_from_jax

    jax.config.update("jax_platforms", "cpu")
    rng = np.random.RandomState(13)
    wavs, lens = rng.randn(2, 8000).astype(np.float32), np.asarray([8000, 6400])

    def layers(hs, ref, h_lens):
        def cat(x, layer):
            return np.concatenate([np.asarray(x[layer, b, :n], np.float64)
                                   for b, n in enumerate(h_lens)]).ravel()
        out = []
        for layer in range(ref.shape[0]):
            a, b = cat(hs, layer), cat(ref, layer)
            out.append(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        return " ".join(f"{c:.5f}" for c in out)

    def port(up, route):
        port_transformer._fused_block_available = lambda x: route == "kernels"
        hs, _ = up.apply_standardized(torch.from_numpy(wavs), torch.from_numpy(lens))
        return hs.float().numpy()

    f32 = jax_registry.load(args.entry)
    want, h_lens = jax.jit(f32.apply_standardized)(f32.params, jnp.asarray(wavs),
                                                   jnp.asarray(lens))
    want, h_lens = np.asarray(want, np.float32), np.asarray(h_lens)
    q8 = jax_registry.load(args.entry, dtype=jnp.bfloat16, quantize=True)
    port_f32 = hub.load(args.entry, device="cpu")
    cfg = port_f32.model.cfg
    sd = trunk_state_dict_from_jax(f32.params["params"], cfg)
    port_f32.model.load_state_dict(sd)
    jax_cfg = jax_registry.Wav2Vec2Config(**dataclasses.asdict(cfg))
    variables = jax_registry._materialize_qcache(  # the int8 cache of the f32 weights
        jax_registry.Wav2Vec2Trunk(jax_cfg, dtype=jnp.bfloat16, quantize=True),
        {"params": f32.params["params"]})
    got_jax, _ = jax.jit(q8.apply_standardized)(variables, jnp.asarray(wavs), jnp.asarray(lens))
    port_q8 = hub.load(args.entry, device="cpu", dtype=torch.bfloat16, flash=True, quantize=True)
    port_q8.model.load_state_dict(sd)
    print(f"{args.entry}, B=2 x 0.5 s, per-layer cosine against the JAX f32 states "
          "(the JAX entry's random weights):")
    print(f"  port f32:           {layers(port(port_f32, 'plain'), want, h_lens)}")
    print(f"  JAX int8 (plain):   {layers(np.asarray(got_jax, np.float32), want, h_lens)}")
    for route in ("plain", "kernels"):
        print(f"  port int8 ({route}): {layers(port(port_q8, route), want, h_lens)}")
    seeded = hub.load(args.entry, device="cpu", seed=0)
    ref = port(seeded, "plain")
    seeded_q8 = hub.load(args.entry, device="cpu", seed=0, dtype=torch.bfloat16, flash=True,
                         quantize=True)
    print("the port's seed-0 weights, against its f32 model:")
    for route in ("plain", "kernels"):
        print(f"  port int8 ({route}): {layers(port(seeded_q8, route), ref, h_lens)}")


if __name__ == "__main__":
    main()
