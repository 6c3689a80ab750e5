"""Reference helpers of the fold tests: the fold kernels of
scripts/exp_fold.py and scripts/roofline_knn.py, each in the pallas_call its
script's launcher builds (padding included), run in interpret mode — the
launchers themselves take no ``interpret`` argument — and the float64
metrics the port's outputs are held to. The kernel-restructure sweeps
(scripts/sweep16*_kernels.py, sweep18_tpose_fold.py) run through their own
launchers: :func:`load_sweep` hands the unedited script small tiles and a
``pallas_call`` that interprets, :func:`recorded_call` runs one of its
variants and keeps what its launcher was given and gave back."""

import numpy as np


def load_script(name: str):
    """``scripts/<name>.py`` as a module, unedited."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_script_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _fold_call(kernel, x, y, *, tile_m, tile_n, n_acc, tpose=False,
               indexed=True):
    """The launchers' pallas_call around ``kernel`` (exp_fold.py:85-116,
    roofline_knn.py:189-281) with the tiles as arguments, interpret=True:
    raw outputs [m, 128]."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    ef = load_script("exp_fold")
    lanes, big = ef.LANES, ef.BIG
    x, y = jnp.asarray(x), jnp.asarray(y)
    m, d = x.shape
    n = y.shape[0]
    xp = ef._pad_rows(x, tile_m)
    yp = ef._pad_rows(y, tile_n)
    y2 = jnp.sum(y * y, axis=1)
    y2p = jnp.pad(y2, (0, yp.shape[0] - n), constant_values=big)[None, :]
    grid = (xp.shape[0] // tile_m, yp.shape[0] // tile_n)
    vmem = pltpu.VMEM
    if tpose:
        xp, yp = xp.T, yp.T
        x_spec = pl.BlockSpec((d, tile_m), lambda i, j: (0, i),
                              memory_space=vmem)
        y_spec = pl.BlockSpec((d, tile_n), lambda i, j: (0, j),
                              memory_space=vmem)
    else:
        x_spec = pl.BlockSpec((tile_m, d), lambda i, j: (i, 0),
                              memory_space=vmem)
        y_spec = pl.BlockSpec((tile_n, d), lambda i, j: (j, 0),
                              memory_space=vmem)
    y2_spec = pl.BlockSpec((1, tile_n), lambda i, j: (0, j),
                           memory_space=vmem)
    out_spec = pl.BlockSpec((tile_m, lanes), lambda i, j: (i, 0),
                            memory_space=vmem)
    rows = xp.shape[1] if tpose else xp.shape[0]
    if not indexed:
        out = pl.pallas_call(
            kernel, grid=grid, in_specs=[x_spec, y_spec, y2_spec],
            out_specs=out_spec,
            out_shape=jax.ShapeDtypeStruct((rows, lanes), jnp.float32),
            scratch_shapes=[vmem((tile_m, lanes), jnp.float32)],
            interpret=True)(xp, yp, y2p)
        return np.asarray(out[:m])
    out_d, out_i = pl.pallas_call(
        kernel, grid=grid, in_specs=[x_spec, y_spec, y2_spec],
        out_specs=[out_spec, out_spec],
        out_shape=[jax.ShapeDtypeStruct((rows, lanes), jnp.float32),
                   jax.ShapeDtypeStruct((rows, lanes), jnp.int32)],
        scratch_shapes=[vmem((tile_m, n_acc * lanes), jnp.float32),
                        vmem((tile_m, n_acc * lanes), jnp.int32)],
        interpret=True)(xp, yp, y2p)
    return np.asarray(out_d[:m]), np.asarray(out_i[:m])


def jax_fold(variant: str, x, y, *, k=5, tile_m=16, tile_n=4096, n_acc=4,
             use_bf16=True):
    """Raw [m, 128] outputs of a fold kernel in interpret mode: ``acc``
    (exp_fold's ``_acc_kernel``), ``dotmin``, ``nodot`` or ``tpose``
    (roofline_knn's)."""
    from functools import partial
    tiles = dict(tile_m=tile_m, tile_n=tile_n, n_acc=n_acc)
    if variant == "acc":
        kernel = partial(load_script("exp_fold")._acc_kernel, k=k,
                         tn=tile_n, n_acc=n_acc, use_bf16=use_bf16)
        return _fold_call(kernel, x, y, **tiles)
    rk = load_script("roofline_knn")
    if variant == "dotmin":
        return _fold_call(partial(rk._dotmin_kernel, tn=tile_n), x, y,
                          indexed=False, **tiles)
    kernel = {"nodot": rk._nodot_kernel, "tpose": rk._tpose_kernel}[variant]
    return _fold_call(partial(kernel, k=k, tn=tile_n, n_acc=n_acc), x, y,
                      tpose=variant == "tpose", **tiles)


def bf16_round(a: np.ndarray) -> np.ndarray:
    """f32 → bf16 (round to nearest even) → f32, in numpy."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def fold_metric64(variant: str, x, y, use_bf16=True):
    """[M, N] float64 metric of a fold kernel: ``y2 − 2·x·y`` over the
    (rounded) operands with y2 from the unrounded y, or K8's
    ``y2 + Σ x``."""
    x64 = np.asarray(x, np.float64)
    y64 = np.asarray(y, np.float64)
    y2 = (y64 * y64).sum(1)
    if variant == "nodot":
        return y2[None, :] + x64.sum(1)[:, None]
    if use_bf16:
        x64 = bf16_round(x).astype(np.float64)
        y64 = bf16_round(y).astype(np.float64)
    return y2[None, :] - 2.0 * x64 @ y64.T


def assert_fold_close(got, want, metric64, atol=1e-5):
    """Raw fold outputs against the reference's: the empty slots (index -1)
    the same, values within ``atol``, and an index that differs only where
    both candidates' metrics lie within ``atol``."""
    gd, gi = (np.asarray(a) for a in got)
    wd, wi = want
    empty = wi < 0
    assert np.array_equal(gi < 0, empty)
    assert np.array_equal(gd[empty], wd[empty])
    assert np.abs(gd[~empty] - wd[~empty]).max(initial=0.0) <= atol
    rows, slots = np.nonzero((gi != wi) & ~empty)
    diff = np.abs(metric64[rows, gi[rows, slots]]
                  - metric64[rows, wi[rows, slots]])
    assert (diff <= atol).all(), diff.max()
    return len(rows)


def load_sweep(name: str, **tiles):
    """``scripts/<name>.py`` loaded unedited, its tile constants set to
    ``tiles`` (e.g. ``TILE_M=16, TILE_N=512``) and its ``pl.pallas_call``
    interpreting: the script's own launchers then run on the CPU."""
    import types
    from functools import partial
    mod = load_script(name)
    real = mod.pl
    proxy = types.SimpleNamespace(**{k: getattr(real, k) for k in dir(real)
                                     if not k.startswith("__")})
    proxy.pallas_call = partial(real.pallas_call, interpret=True)
    mod.pl = proxy
    for key, value in tiles.items():
        assert hasattr(mod, key), key
        setattr(mod, key, value)
    return mod


def recorded_call(mod, launcher: str, fn, *args, **kwargs):
    """Run the script's variant ``fn`` (its jit taken off, so that the
    operands are arrays) with the module's ``launcher`` recorded: (the
    variant's result, [(positional operands, keyword arguments, raw
    outputs) of each launch]), all as numpy."""
    real = getattr(mod, launcher)
    calls = []

    def recorder(*a, **kw):
        out = real(*a, **kw)
        calls.append(([np.asarray(v) if hasattr(v, "shape") else v
                       for v in a],
                      {k: np.asarray(v) if hasattr(v, "shape") else v
                       for k, v in kw.items()},
                      tuple(np.asarray(o) for o in out)))
        return out
    setattr(mod, launcher, recorder)
    try:
        out = getattr(fn, "__wrapped__", fn)(*args, **kwargs)
    finally:
        setattr(mod, launcher, real)
    return tuple(np.asarray(o) for o in out), calls
