#!/usr/bin/env python3
"""How many of the mamba decode step's f32 state values the port shares
bit for bit with the reference, and what a single-rounding update changes.

One ``ssd_decode_step`` at zamba2-1.2b's widths (b 4, H 64, N 64, P 64,
G 1) on random inputs (seed 0), the reference's jitted step on the CPU
against:

1. the port's step as it is (``dec * state + upd``: the product and the
   sum each rounded to f32);
2. the same update with one rounding (the f32 product is exact in f64;
   the sum is rounded once, to f64 and then to f32), as XLA fuses it;
3. that update on XLA's own ``exp(dt A)``.

Prints the share of state values that are bitwise equal for each, and the
share of ``exp(dt A)`` values on which PyTorch and XLA agree.  Imports both
packages, so it runs where JAX is installed.

  PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_ssm_state_rounding.py
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> dict:
    import jax
    import jax.numpy as jnp
    import torch

    from repro.models import ssm as J
    from repro_torch.models import ssm as P

    rng = np.random.default_rng(0)
    b, H, N, Pd, G = 4, 64, 64, 64, 1
    state = rng.standard_normal((b, H, N, Pd)).astype(np.float32)
    x = rng.standard_normal((b, H, Pd)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((b, H))) * 0.1).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    B = rng.standard_normal((b, G, N)).astype(np.float32)
    C = rng.standard_normal((b, G, N)).astype(np.float32)
    args = (state, x, dt, A, B, C)
    _, want = jax.jit(J.ssd_decode_step)(*map(jnp.asarray, args))
    want = np.asarray(want)

    t = [torch.from_numpy(a.copy()) for a in args]
    _, port = P.ssd_decode_step(*t)
    dtf, At, xt = t[2], t[3], t[1]
    Bf = t[4].repeat_interleave(H // G, dim=1)
    upd = torch.einsum("bh,bhn,bhp->bhnp", dtf, Bf, xt).double()
    dec = torch.exp(dtf * At[None])
    xla_dec = torch.from_numpy(np.asarray(jax.jit(
        lambda d, a: jnp.exp(d * a[None]))(dt, A)).copy())

    def once(d):
        return (d.double()[:, :, None, None] * t[0].double()
                + upd).float().numpy()

    out = {"port_as_is": float((port.numpy() == want).mean()),
           "single_rounding": float((once(dec) == want).mean()),
           "single_rounding_xla_exp": float((once(xla_dec) == want).mean()),
           "exp_equal": float((dec == xla_dec).float().mean())}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
