"""Camera refinement by Gauss-Newton on reprojection error, the `use_ba`
path (counterpart of regen3d_tpu/ops/bundle_adjust.py).

The reference optionally runs pycolmap/Ceres bundle adjustment over VGGT
tracks (minimal_demo_vggt.py:414-456, off by default at config.yaml:233).
As in the JAX package, a damped Gauss-Newton loop of a fixed number of
iterations with a step-acceptance gate, on the device, with no host read
inside the loop (``torch.where`` in place of ``lax.scan``'s select);
Jacobians by ``torch.func.jacfwd`` under ``torch.func.vmap``, products at
full f32.

Two entry points:
  * :func:`refine_camera_gn` — points fixed, per-camera 7-DOF refinement
    (rotation, translation, log-focal).
  * :func:`joint_bundle_adjust` — the pycolmap.bundle_adjustment role
    (minimal_demo_vggt.py:455-456): M cameras + N points refined jointly
    with the Schur complement over the points — V (the point block) is a
    batched (N, 3, 3) inverse, the reduced camera system a (7M, 7M) dense
    solve. The gauge is fixed by freezing camera 0.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.func import jacfwd, vmap

from regen3d_tpu_torch.ops import full_f32
from regen3d_tpu_torch.transforms.rotations import so3_exp, so3_log


class BAResult(NamedTuple):
    R: torch.Tensor        # (3, 3) world→view (row-vector convention)
    T: torch.Tensor        # (3,)
    focal: torch.Tensor    # scalar (pixels)
    rmse_px: torch.Tensor  # final reprojection RMSE
    num_iters: int


def _rotation(aa: torch.Tensor) -> torch.Tensor:
    """so3_exp of one axis-angle (3,), taken as a batch of one: under
    ``torch.func.jacfwd`` a 0-dim tensor plus a Python scalar (so3_exp's
    eps) gets an f64 tangent, which the products then refuse."""
    return so3_exp(aa[None])[0]


def _project(params, points, principal):
    """params = (aa (3,), t (3,), log_f); row-convention pinhole."""
    aa, t, log_f = params[:3], params[3:6], params[6]
    v = points @ _rotation(aa) + t
    z = torch.clamp(v[:, 2], min=1e-6)
    f = torch.exp(log_f)
    u = principal[0] + f * v[:, 0] / z
    w = principal[1] + f * v[:, 1] / z
    return torch.stack([u, w], -1)


def refine_camera_gn(
    points3d: torch.Tensor,
    observations: torch.Tensor,
    R_init: torch.Tensor,
    T_init: torch.Tensor,
    focal_init: float,
    principal: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    max_iterations: int = 20,
    damping: float = 1e-4,
    refine_focal: bool = True,
) -> BAResult:
    """Minimize Σ w‖project(X) − obs‖² over (rotation, translation[, focal]).

    points3d: (N, 3) fixed world points; observations: (N, 2) pixels.
    Levenberg-style damped Gauss-Newton, a fixed number of iterations with
    a step-acceptance gate instead of data-dependent exits."""
    dev = points3d.device
    points3d = points3d.float()
    observations = observations.float()
    principal = torch.as_tensor(principal, dtype=torch.float32, device=dev)
    n = points3d.shape[0]
    w = (torch.ones(n, device=dev) if weights is None
         else weights.float())
    sw = torch.sqrt(w / torch.clamp(torch.sum(w), min=1e-12))

    p0 = torch.cat([
        so3_log(torch.as_tensor(R_init, dtype=torch.float32, device=dev)),
        torch.as_tensor(T_init, dtype=torch.float32, device=dev),
        torch.log(torch.tensor([focal_init], dtype=torch.float32,
                               device=dev))])

    def residuals(params):
        r = _project(params, points3d, principal) - observations
        return (r * sw[:, None]).reshape(-1)

    jac_fn = jacfwd(residuals)
    mask = torch.tensor([1.0] * 6 + [1.0 if refine_focal else 0.0],
                        device=dev)
    eye = torch.eye(7, device=dev)
    params, lam = p0, torch.tensor(damping, dtype=torch.float32, device=dev)
    with full_f32():
        for _ in range(max_iterations):
            r = residuals(params)
            J = jac_fn(params) * mask[None, :]
            H = J.T @ J + lam * eye
            g = J.T @ r
            delta = torch.linalg.solve(H, g)
            cand = params - delta * mask
            better = torch.sum(residuals(cand) ** 2) < torch.sum(r ** 2)
            params = torch.where(better, cand, params)
            lam = torch.where(better, torch.clamp(lam * 0.5, min=1e-8),
                              lam * 4.0)
        r = residuals(params)
    rmse = torch.sqrt(torch.sum(r ** 2))
    return BAResult(R=so3_exp(params[:3]), T=params[3:6],
                    focal=torch.exp(params[6]), rmse_px=rmse,
                    num_iters=max_iterations)


class JointBAResult(NamedTuple):
    R: torch.Tensor         # (M, 3, 3) world→view per camera
    T: torch.Tensor         # (M, 3)
    focal: torch.Tensor     # (M,) pixels
    points3d: torch.Tensor  # (N, 3) refined structure
    rmse_px: torch.Tensor   # weighted reprojection RMSE (pixels)


def _project_one(cam_params: torch.Tensor, point: torch.Tensor,
                 principal: torch.Tensor) -> torch.Tensor:
    """cam_params = (aa (3,), t (3,), log_f); one point → (u, v)."""
    aa, t, log_f = cam_params[:3], cam_params[3:6], cam_params[6]
    v = point @ _rotation(aa) + t
    z = torch.clamp(v[2], min=1e-6)
    f = torch.exp(log_f)
    return principal + f * v[:2] / z


# (M, 7) cameras, (N, 3) points, (M, 2) principal points → the Jacobians
# (M, N, 2, 7) and (M, N, 2, 3)
_JAC = vmap(vmap(jacfwd(_project_one, argnums=(0, 1)), in_dims=(None, 0, None)),
            in_dims=(0, None, 0))
_PROJ = vmap(vmap(_project_one, in_dims=(None, 0, None)), in_dims=(0, None, 0))


def joint_bundle_adjust(
    points3d: torch.Tensor,
    observations: torch.Tensor,
    weights: torch.Tensor,
    R_init: torch.Tensor,
    T_init: torch.Tensor,
    focal_init: torch.Tensor,
    principal: torch.Tensor,
    max_iterations: int = 30,
    damping: float = 1e-3,
    refine_focal: bool = True,
    shared_focal: bool = False,
) -> JointBAResult:
    """Joint structure+pose BA: min Σ_{ij} w_ij ‖π_i(X_j) − obs_ij‖².

    points3d (N, 3) initial structure; observations (M, N, 2) pixels;
    weights (M, N) with 0 = unobserved (track invisible in that frame);
    R_init (M, 3, 3) / T_init (M, 3) / focal_init (M,) initial cameras;
    principal (M, 2). Camera 0 is frozen (gauge). All on points3d's
    device, in f32."""
    dev = points3d.device
    m, n = observations.shape[:2]

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    observations = f32(observations)
    w = torch.clamp(f32(weights), min=0.0)
    cam0 = torch.cat([so3_log(f32(R_init)), f32(T_init),
                      torch.log(f32(focal_init))[:, None]], -1)
    pts0 = f32(points3d)
    principal = f32(principal)

    # the gauge freeze needs only camera 0's POSE; its focal stays free when
    # focals are shared so all frames converge to one common focal
    f0_free = 1.0 if (refine_focal and shared_focal) else 0.0
    cam_mask = torch.cat([
        torch.cat([torch.zeros(1, 6), torch.full((1, 1), f0_free)], -1),
        torch.cat([torch.ones(m - 1, 6),
                   torch.full((m - 1, 1), 1.0 if refine_focal else 0.0)],
                  -1)]).to(dev)
    eye_m = torch.eye(m, device=dev)
    eye3 = torch.eye(3, device=dev)
    eye7 = torch.eye(7, device=dev)
    # freeze camera 0: identity rows/cols for its masked params keep S
    # nonsingular without moving it
    diag_fix = torch.einsum("mk,ab,ma->makb", eye_m, eye7, 1.0 - cam_mask)

    def resid_raw(cams, pts):
        return _PROJ(cams, pts, principal) - observations     # (M, N, 2)

    def total_err(cams, pts):
        return torch.sum(w[..., None] * resid_raw(cams, pts) ** 2)

    cams, pts = cam0, pts0
    lam = torch.tensor(damping, dtype=torch.float32, device=dev)
    with full_f32():
        for _ in range(max_iterations):
            r = resid_raw(cams, pts)
            jc, jp = _JAC(cams, pts, principal)
            jc = jc * cam_mask[:, None, None, :]
            sw = w[..., None, None]

            U = torch.einsum("mnia,mnib->mab", jc * sw, jc)     # (M, 7, 7)
            V = torch.einsum("mnia,mnib->nab", jp * sw, jp)     # (N, 3, 3)
            W = torch.einsum("mnia,mnib->mnab", jc * sw, jp)    # (M, N, 7, 3)
            gc = torch.einsum("mnia,mni->ma", jc * sw, r)       # Jᵀ·w·r
            gp = torch.einsum("mnia,mni->na", jp * sw, r)

            V = V + lam * eye3[None]
            Vinv = torch.linalg.inv(V)                          # batched 3×3

            WVinv = torch.einsum("mnab,nbc->mnac", W, Vinv)     # (M, N, 7, 3)
            # the reduced camera system S (M, 7, M, 7)
            S = torch.einsum("mnab,kncb->makc", WVinv, W) * -1.0
            S = S + torch.einsum("mk,mab->makb", eye_m,
                                 U + lam * eye7[None])
            b = gc - torch.einsum("mnab,nb->ma", WVinv, gp)
            S = S * cam_mask[:, :, None, None] * cam_mask[None, None] \
                + diag_fix
            b = b * cam_mask

            dc = torch.linalg.solve(S.reshape(m * 7, m * 7),
                                    b.reshape(m * 7)).reshape(m, 7)
            dp = torch.einsum("nab,nb->na", Vinv,
                              gp - torch.einsum("mnba,mb->na", W, dc))

            cand_c = cams - dc * cam_mask
            if shared_focal and refine_focal:
                # all frames share one focal: the mean of the (all-free)
                # candidate log-focals, camera 0 included
                cand_c = torch.cat([cand_c[:, :6], torch.mean(
                    cand_c[:, 6]).expand(m, 1)], -1)
            cand_p = pts - dp

            better = total_err(cand_c, cand_p) < total_err(cams, pts)
            cams = torch.where(better, cand_c, cams)
            pts = torch.where(better, cand_p, pts)
            lam = torch.where(better, torch.clamp(lam * 0.5, min=1e-8),
                              lam * 4.0)
        rmse = torch.sqrt(torch.sum(w[..., None] * resid_raw(cams, pts) ** 2)
                          / torch.clamp(torch.sum(w) * 2.0, min=1.0))
    return JointBAResult(R=so3_exp(cams[:, :3]), T=cams[:, 3:6],
                         focal=torch.exp(cams[:, 6]), points3d=pts,
                         rmse_px=rmse)
