"""Scene-adapted fine-tuning of the OIDN UNet on this renderer's noise.

Why this exists: the rmse8 fidelity gate (8 spp + denoise vs a converged
golden, RMSE <= 1e-2) plateaus at ~0.012 on vw-van with the shipped
rt_ldr weights. Earlier rounds measured and rejected every estimator-
and post-side lever; the residual is the denoiser's
PRIOR mismatch — the reference ships fixed weights trained on Intel's
renderer family (TracerBoy/ML/rt_ldr.tza, loaded at
OpenImageDenoise.cpp:855 and never adapted; OpenImageDenoise.h:219 even
hard-disables the aux-guided variant). A JAX framework can do what a
fixed DirectML graph cannot: fine-tune the same UNet on THIS
renderer's noise distribution at the gate's sample count, on the same
device that renders.

Method — noisier-target supervised fine-tuning (the noise2noise
observation): inputs are low-spp renders, targets are INDEPENDENT
higher-spp renders of the same view. Under an L2 loss the minimizer is
the clean conditional mean, so unbiased target noise costs only
training-signal variance, never bias — converged targets are not
required. Views orbit the gate camera without ever including it
(scene-family adaptation, not golden memorization; the gate view and
its golden stay out of training).

The train-time transfer matches inference (bench.py bench_oidn_rmse)
exactly: auto-expose -> invertible Reinhard x/(1+x) -> gamma 1/2.2,
denoise in that display-referred space.
"""

from __future__ import annotations

import os

import numpy as np

# ---------------------------------------------------------------------------
# The inference transfer (must stay bit-identical to bench_oidn_rmse).
# ---------------------------------------------------------------------------


def reinhard_fwd(x: np.ndarray) -> np.ndarray:
    """Linear HDR -> invertible display-referred net space."""
    x = np.maximum(np.asarray(x, np.float32), 0.0)
    return (x / (1.0 + x)) ** (1 / 2.2)


def reinhard_inv(y: np.ndarray) -> np.ndarray:
    y = np.clip(np.asarray(y, np.float32), 0.0, 0.995) ** 2.2
    return y / (1.0 - y)


# ---------------------------------------------------------------------------
# Dataset: orbit-view render pairs
# ---------------------------------------------------------------------------


def orbit_offsets(n: int, diag: float, rng: np.random.Generator):
    """n small camera perturbations (move_camera kwargs) around the
    current view: yaw/pitch up to ~6 deg, translate up to ~1.5% of the
    scene diagonal. Large enough that no training view shares the gate
    view's pixel grid, small enough to stay in the same lighting
    regime."""
    views = []
    for _ in range(n):
        views.append(dict(
            yaw=float(rng.uniform(-0.10, 0.10)),
            pitch=float(rng.uniform(-0.06, 0.06)),
            forward=float(rng.uniform(-1.0, 1.0)) * 0.015 * diag,
            strafe=float(rng.uniform(-1.0, 1.0)) * 0.015 * diag,
            upward=float(rng.uniform(-1.0, 1.0)) * 0.008 * diag,
        ))
    return views


def make_dataset(scene_path: str, out_npz: str, film=(512, 320),
                 n_views: int = 48, input_spp: int = 8,
                 target_spp: int = 128, inputs_per_view: int = 2,
                 seed: int = 1, progress=print):
    """Render (noisy input, noisier-target) pairs on orbit views.

    Stores LINEAR radiance float16 (HDR survives: vw-van peaks < 1e3)
    plus the per-view auto-exposure scale computed from the FIRST noisy
    input — matching inference, where exposure comes from the 8-spp
    frame being denoised.
    """
    import jax.numpy as jnp

    from tracerboy_tpu.post.pipeline import auto_exposure_scale
    from tracerboy_tpu.renderer import Renderer

    r = Renderer(scene_path, film_size=film)
    diag = float(np.linalg.norm(
        np.asarray(r.compiled.bvh_hi[0]) - np.asarray(r.compiled.bvh_lo[0])))
    rng = np.random.default_rng(seed)
    views = orbit_offsets(n_views, diag, rng)

    cam = r.compiled.camera
    cam0 = {f: np.array(getattr(cam, f))
            for f in ("position", "look_at", "right", "up")}

    inps, tgts, expos, view_ids = [], [], [], []
    for vi, v in enumerate(views):
        r.move_camera(**v)

        def shot(spp, s):
            r.seed = int(s)
            r.invalidate_history()
            r.render_sample(spp)
            return np.maximum(
                np.asarray(r.resolve_radiance(), np.float32), 0.0)

        tgt = shot(target_spp, 7_000_000 + vi)
        for k in range(inputs_per_view):
            inp = shot(input_spp, 1000 * vi + 17 * k + 1)
            if k == 0:
                expo = float(auto_exposure_scale(jnp.asarray(inp)))
            inps.append(inp.astype(np.float16))
            tgts.append(tgt.astype(np.float16))
            expos.append(expo)
            view_ids.append(vi)
        progress(f"view {vi + 1}/{n_views} done")
        # restore the gate camera exactly (rotations don't commute, so
        # an inverse walk would drift); each view is an independent
        # perturbation of the ORIGINAL view, never of the previous one.
        for f, val in cam0.items():
            setattr(cam, f, val.copy())
        r.scene_pytree["camera"] = cam.as_pytree()
        r.invalidate_history()

    os.makedirs(os.path.dirname(out_npz), exist_ok=True)
    np.savez_compressed(
        out_npz, inp=np.stack(inps), tgt=np.stack(tgts),
        expo=np.asarray(expos, np.float32),
        view=np.asarray(view_ids, np.int32),
        meta=np.asarray([input_spp, target_spp], np.int32))
    progress(f"wrote {out_npz}: {len(inps)} pairs")


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _net_space(lin_f16: np.ndarray, expo: np.ndarray) -> np.ndarray:
    """(N,H,W,3) linear float16 + (N,) exposure -> net-space float32."""
    return reinhard_fwd(
        lin_f16.astype(np.float32) * expo[:, None, None, None])


def finetune(dataset_npz: str, out_npz: str,
             init_weights: str | None = None,
             steps: int = 1500, lr: float = 1e-4, batch: int = 4,
             holdout_views: int = 2, seed: int = 0, log_every: int = 100,
             progress=print):
    """Fine-tune the UNet from init_weights (.tza or .npz; default the
    committed network); saves the params as float16 .npz.

    Full-frame batches (inference is full-frame; crops would shift the
    receptive-field statistics), random flip augmentation — the SAME
    dihedral family the inference-side TTA averages over. L2 loss in
    net space (the noisier-target argument above requires L2, not L1:
    the L1 minimizer is a median, which Monte-Carlo noise skews).
    Returns (initial, final) holdout loss.
    """
    import jax
    import jax.numpy as jnp
    import optax

    from tracerboy_tpu.ml.oidn import DEFAULT_WEIGHTS, load_oidn, unet_apply

    d = np.load(dataset_npz)
    X = _net_space(d["inp"], d["expo"])
    Y = _net_space(d["tgt"], d["expo"])
    view = d["view"]
    hold = view >= (view.max() + 1 - holdout_views)
    Xh, Yh = X[hold], Y[hold]
    X, Y = X[~hold], Y[~hold]

    params = load_oidn(init_weights or DEFAULT_WEIGHTS)
    sched = optax.cosine_decay_schedule(lr, steps)
    opt = optax.adam(sched)
    opt_state = opt.init(params)

    @jax.jit
    def train_step(params, opt_state, x, y):
        def loss_fn(p):
            out = unet_apply(p, x, dtype=jnp.float32)
            return jnp.mean(jnp.square(out - y.astype(out.dtype)))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    @jax.jit
    def eval_loss(params, x, y):
        out = unet_apply(params, x, dtype=jnp.float32)
        return jnp.mean(jnp.square(out - y.astype(out.dtype)))

    def holdout(params):
        if not len(Xh):
            return float("nan")
        tot = 0.0
        for i in range(0, len(Xh), batch):
            xb, yb = Xh[i:i + batch], Yh[i:i + batch]
            tot += float(eval_loss(params, xb, yb)) * len(xb)
        return tot / len(Xh)

    rng = np.random.default_rng(seed)
    h0 = holdout(params)
    progress(f"holdout L2 before: {h0:.6f} ({len(X)} train pairs)")
    for step in range(steps):
        idx = rng.integers(0, len(X), size=batch)
        xb, yb = X[idx], Y[idx]
        if rng.random() < 0.5:
            xb, yb = xb[:, :, ::-1], yb[:, :, ::-1]
        if rng.random() < 0.5:
            xb, yb = xb[:, ::-1], yb[:, ::-1]
        params, opt_state, loss = train_step(
            params, opt_state, jnp.asarray(xb), jnp.asarray(yb))
        if (step + 1) % log_every == 0:
            progress(f"step {step + 1}/{steps} "
                     f"train L2 {float(loss):.6f}")
    h1 = holdout(params)
    progress(f"holdout L2 after: {h1:.6f} (before: {h0:.6f})")

    save_params_npz(out_npz, params)
    return h0, h1


def save_params_npz(path: str, params: dict):
    """UNet params -> flat float16 npz (~6.5 MB for rt_ldr)."""
    flat = {}
    for name, p in params.items():
        flat[f"{name}.kernel"] = np.asarray(p["kernel"], np.float16)
        flat[f"{name}.bias"] = np.asarray(p["bias"], np.float16)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **flat)


def load_params_npz(path: str) -> dict:
    """Inverse of save_params_npz -> {layer: {kernel, bias}} (f32)."""
    import jax.numpy as jnp

    d = np.load(path)
    params = {}
    for key in d.files:
        name, kind = key.rsplit(".", 1)
        params.setdefault(name, {})[kind] = jnp.asarray(
            d[key], jnp.float32)
    return params
