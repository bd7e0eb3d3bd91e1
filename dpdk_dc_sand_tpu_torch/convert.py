"""Carry the reference engine's state into the port.

:func:`from_reference_state` loads the JAX engine's window, steering
blocks and fine-rotation planes — handed over as numpy arrays — into a
port engine's buffers and caches:

- from the JAX ``FBEngine``: ``np.asarray(fb.window)``,
  ``np.asarray(fb._coeff_blocks)`` (for ``bstage="planar"`` the pair
  ``[np.asarray(w) for w in fb._coeff_blocks]``),
  ``[np.asarray(r) for r in fb._rot_planes]``;
- from the JAX ``FXBEngine`` (into the port's ``FXBEngine``):
  ``np.asarray(fxb.window)``, ``np.asarray(fxb._coeffs)``, and the rotation
  planes that engine computes inside its jit, taken from the JAX
  ``fine_rotation_planes`` for the same fine delays and phases (``None``
  for an engine with ``fengine="xla"``, which rotates inside its chain).

:func:`load_window` carries the JAX ``FEngine``'s ``window`` (its only
state: the delay solution is an input of every step) into the port's
``FEngine``, or any port engine's.

:func:`load_sharded_state` carries the JAX ``ShardedFBEngine``'s window and
its global steering planes (``np.asarray(eng.window)``, ``[np.asarray(x)
for x in eng._coeffs]``) into one rank's port ``ShardedFBEngine``.

Both packages then run their kernels on identical operands, so a comparison
isolates the kernels from cos/sin ulp differences between the two
frameworks. Nothing here imports jax.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from dpdk_dc_sand_tpu_torch.models.fbengine import FBEngine, _rot_key
from dpdk_dc_sand_tpu_torch.ops.coeff_gen import steering_key


def load_window(engine: nn.Module, window) -> nn.Module:
    """Load the reference engine's ``[taps, fft]`` f32 PFB window into ``engine``."""
    cfg = engine.cfg
    win = torch.as_tensor(np.array(window, np.float32), device=engine.device)
    if tuple(win.shape) != (cfg.n_taps, cfg.fft_size):
        raise ValueError(f"window shape {tuple(win.shape)}")
    engine.window = win
    return engine


def from_reference_state(
    engine: FBEngine,
    window,
    coeff_blocks,
    rot_planes,
    *,
    delay_vals,
    frac_delays,
    phases,
    ant_weights=None,
    t_s: float = 0.0,
) -> FBEngine:
    """Load reference state into ``engine`` for the given delay solution.

    ``engine`` is an ``FBEngine`` or an ``FXBEngine`` (a subclass).

    ``window`` ``[taps, fft]`` f32; ``coeff_blocks`` ``[C, 2A, 2B]``, or for
    an engine with ``bstage="planar"`` the reference's ``(cos, sin)`` pair,
    each ``[C, B, A]`` (stored in the engine's precision dtype);
    ``rot_planes`` ``(cos, sin)`` each ``[A, P, N2/2, N1]`` f32, or ``None``
    to leave them to the engine. The caches are keyed to ``delay_vals`` /
    ``ant_weights`` / ``t_s`` and ``frac_delays`` / ``phases``, so steps with
    that solution use the loaded state until the solution changes.
    """
    cfg = engine.cfg
    dev = engine.device
    dtype = torch.bfloat16 if engine.precision == "bf16" else torch.float32
    if engine.bstage == "planar":
        want = (2, cfg.n_channels, cfg.n_beams, cfg.n_ants)
        blocks = torch.stack([torch.as_tensor(np.array(w, np.float32), device=dev)
                              for w in coeff_blocks])
    else:
        want = (cfg.n_channels, 2 * cfg.n_ants, 2 * cfg.n_beams)
        blocks = torch.as_tensor(np.array(coeff_blocks, np.float32), device=dev)
    if tuple(blocks.shape) != want:
        raise ValueError(f"coeff_blocks shape {tuple(blocks.shape)}, want {want}")
    load_window(engine, window)
    engine.coeff_blocks = blocks.to(dtype)
    engine._coeff_key = steering_key(delay_vals, ant_weights, t_s)
    if rot_planes is not None:
        rc, rs = (torch.as_tensor(np.array(r, np.float32), device=dev) for r in rot_planes)
        engine.rot_cos, engine.rot_sin = rc, rs
        engine._rot_key = _rot_key(frac_delays, phases)
    return engine


def load_sharded_state(engine, window, cos, sin, *, delay_vals, ant_weights=None,
                       t_s: float = 0.0):
    """Load the reference sharded engine's state into this rank's ``engine``.

    ``window`` ``[taps, fft]`` f32; ``cos``, ``sin`` the global ``[C, B, A]``
    steering planes with the antenna weights folded in. The engine keeps
    its own ``[C_loc, B, A_loc]`` block (block-concatenated for a folded B
    form), in its precision's dtype, keyed to ``delay_vals`` /
    ``ant_weights`` / ``t_s``, so steps with that solution use it until the
    solution changes.
    """
    cfg = engine.cfg
    want = (cfg.n_channels, cfg.n_beams, cfg.n_ants)
    pair = torch.stack([torch.as_tensor(np.array(w, np.float32), device=engine.device)
                        for w in (cos, sin)])
    if tuple(pair.shape[1:]) != want:
        raise ValueError(f"steering planes {tuple(pair.shape[1:])}, want {want}")
    load_window(engine, window)
    engine._load_planes(pair, steering_key(delay_vals, ant_weights, t_s))
    return engine
