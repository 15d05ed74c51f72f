"""Per-frame front-end: one jitted program builds the full working set.

JAX replacement for the reference's `Frame` constructor pipeline
(reference: src/Frame.cc:98-230 — 4 extraction threads, undistortion,
`ComputeStereoMatches` :976, `ComputeStereoMatches_Lines` :1156,
`AssignFeaturesToGrid` :451). Here the whole thing — both pyramids,
FAST, descriptors, line detection, stereo point+line association — is
one XLA program; there is no feature grid because matching is dense
(ops/matching.py).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from pli_slam_tpu.ops import lines as line_ops
from pli_slam_tpu.ops import orb, stereo
from pli_slam_tpu.ops.camera import Camera
from pli_slam_tpu.ops.lines import LineFeatures
from pli_slam_tpu.ops.orb import Features
from pli_slam_tpu.utils.config import SlamConfig


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FrameData:
    """Everything tracking needs about one stereo frame."""

    feats: Features  # left-image ORB features
    u_right: jax.Array  # [N] refined right-image u (reference mvuRight)
    stereo_ok: jax.Array  # [N] bool
    depth: jax.Array  # [N] depth from disparity, -1 where invalid
    lines: LineFeatures  # left-image line segments
    line_disp: jax.Array  # [Nl,2] endpoint disparities
    line_ok: jax.Array  # [Nl] bool — stereo line association valid
    sigma2: jax.Array  # [N] per-feature measurement variance (scale^2)


def build_frame(cam: Camera, cfg: SlamConfig, img_l: jax.Array, img_r: jax.Array) -> FrameData:
    # L/R extraction stays as two sequential sub-graphs inside the one
    # jitted program rather than one [2,H,W]-vmapped graph: XLA lowered
    # the batched keypoint gathers / top-k poorly on an earlier
    # accelerator (a design choice not yet measured on the card)
    fl = orb.extract(img_l, cfg.orb)
    fr = orb.extract(img_r, cfg.orb)
    u_r, sok = stereo.match_stereo(
        fl, fr, img_l, img_r, max_disparity=cfg.match.stereo_max_disparity
    )
    depth = stereo.depths_from_stereo(fl, u_r, sok, cam.bf)

    if cfg.use_lines:
        ll = line_ops.detect(img_l, cfg.lines)
        # right lines feed ONLY endpoint-disparity association: the
        # geometric+photometric matcher needs no right LBD descriptor
        lr = line_ops.detect(img_r, cfg.lines, with_desc=False)
        d0, d1, _, lok = line_ops.match_stereo_lines_geom(
            ll, lr, img_l, img_r, max_disparity=cfg.match.stereo_max_disparity
        )
        line_disp = jnp.stack([d0, d1], axis=-1)
    else:
        nl = cfg.lines.n_lines
        ll = LineFeatures(
            p0=jnp.zeros((nl, 2)), p1=jnp.zeros((nl, 2)), angle=jnp.zeros(nl),
            length=jnp.zeros(nl), response=jnp.zeros(nl),
            desc=jnp.zeros((nl, 256), jnp.int8), valid=jnp.zeros(nl, bool),
        )
        line_disp = jnp.zeros((nl, 2))
        lok = jnp.zeros(nl, bool)

    sigma2 = fl.scale ** 2
    return FrameData(
        feats=fl, u_right=u_r, stereo_ok=sok, depth=depth,
        lines=ll, line_disp=line_disp, line_ok=lok, sigma2=sigma2,
    )


def _empty_lines(cfg: SlamConfig) -> LineFeatures:
    nl = cfg.lines.n_lines
    return LineFeatures(
        p0=jnp.zeros((nl, 2)), p1=jnp.zeros((nl, 2)), angle=jnp.zeros(nl),
        length=jnp.zeros(nl), response=jnp.zeros(nl),
        desc=jnp.zeros((nl, 256), jnp.int8), valid=jnp.zeros(nl, bool),
    )


def _sample_depth(depth_img: jax.Array, uv: jax.Array) -> jax.Array:
    """Nearest-neighbor depth lookup at (possibly sub-pixel) keypoints."""
    h, w = depth_img.shape
    ui = jnp.clip(jnp.round(uv[..., 0]).astype(jnp.int32), 0, w - 1)
    vi = jnp.clip(jnp.round(uv[..., 1]).astype(jnp.int32), 0, h - 1)
    return depth_img[vi, ui]


def build_frame_rgbd(cam: Camera, cfg: SlamConfig, img: jax.Array, depth_img: jax.Array) -> FrameData:
    """RGB-D frame: depth sampled at features becomes a virtual right
    coordinate u_r = u - bf/d, exactly the reference's
    `ComputeStereoFromRGBD` trick (src/Frame.cc RGB-D ctor :231), so the
    whole stereo tracking/BA machinery applies unchanged."""
    fl = orb.extract(img, cfg.orb)
    d = _sample_depth(depth_img, fl.uv)
    ok = fl.valid & (d > 0.0)
    d_safe = jnp.maximum(d, 1e-6)
    u_r = jnp.where(ok, fl.uv[:, 0] - cam.bf / d_safe, -1.0)
    depth = jnp.where(ok, d, -1.0)

    if cfg.use_lines:
        ll = line_ops.detect(img, cfg.lines)
        d0 = _sample_depth(depth_img, ll.p0)
        d1 = _sample_depth(depth_img, ll.p1)
        lok = ll.valid & (d0 > 0.0) & (d1 > 0.0)
        line_disp = jnp.stack(
            [cam.bf / jnp.maximum(d0, 1e-6), cam.bf / jnp.maximum(d1, 1e-6)], axis=-1
        )
        line_disp = jnp.where(lok[:, None], line_disp, 0.0)
    else:
        ll = _empty_lines(cfg)
        line_disp = jnp.zeros((cfg.lines.n_lines, 2))
        lok = jnp.zeros(cfg.lines.n_lines, bool)

    return FrameData(
        feats=fl, u_right=u_r, stereo_ok=ok, depth=depth,
        lines=ll, line_disp=line_disp, line_ok=lok, sigma2=fl.scale ** 2,
    )


def undistort_uv(cam: Camera, uv: jax.Array) -> jax.Array:
    """Map observed (fisheye) pixel coords to ideal-pinhole pixel coords
    with the same fx/fy/cx/cy — the reference's keypoint undistortion
    (Frame::UndistortKeyPoints, src/Frame.cc:872): downstream matching /
    solving then runs on an undistorted pinhole camera."""
    from pli_slam_tpu.ops import camera as cam_ops

    ray = cam_ops.unproject(cam, uv)  # KB8 Newton inversion, z=1
    return jnp.stack(
        [cam.fx * ray[..., 0] + cam.cx, cam.fy * ray[..., 1] + cam.cy], axis=-1
    )


def build_frame_mono(cam: Camera, cfg: SlamConfig, img: jax.Array) -> FrameData:
    """Monocular frame: no stereo/depth channel (reference mono ctor
    src/Frame.cc:334). Depth for landmark creation comes later from
    two-view initialization / triangulation against the last keyframe.

    With a Kannala-Brandt8 `cam` (reference fisheye path,
    src/CameraModels/KannalaBrandt8.cpp), features and line endpoints
    are extracted on the raw fisheye image and their coordinates are
    undistorted to the ideal pinhole frame here; the tracker's solve /
    match / BA stack then runs entirely on that pinhole model."""
    from pli_slam_tpu.ops import camera as cam_ops

    fl = orb.extract(img, cfg.orb)
    n = fl.uv.shape[0]
    if cfg.use_lines:
        ll = line_ops.detect(img, cfg.lines)
    else:
        ll = _empty_lines(cfg)
    if cam.model == cam_ops.KANNALA_BRANDT8:
        fl = dataclasses.replace(fl, uv=undistort_uv(cam, fl.uv))
        if cfg.use_lines:
            ll = dataclasses.replace(
                ll, p0=undistort_uv(cam, ll.p0), p1=undistort_uv(cam, ll.p1)
            )
    return FrameData(
        feats=fl,
        u_right=jnp.full(n, -1.0),
        stereo_ok=jnp.zeros(n, bool),
        depth=jnp.full(n, -1.0),
        lines=ll,
        line_disp=jnp.zeros((cfg.lines.n_lines, 2)),
        line_ok=jnp.zeros(cfg.lines.n_lines, bool),
        sigma2=fl.scale ** 2,
    )


def build_frame_fisheye_stereo(
    cam_l: Camera, cam_r: Camera, cfg: SlamConfig,
    R_rl: jax.Array, t_rl: jax.Array,
    img_l: jax.Array, img_r: jax.Array,
) -> FrameData:
    """Fisheye (KB8) stereo frame — the unrectified-rig path.

    The reference handles KB8 stereo with a dedicated Frame constructor
    (src/Frame.cc:1484) and `KannalaBrandt8::matchAndtriangulate`
    (src/CameraModels/KannalaBrandt8.cpp:240): no rectification exists
    for fisheye, so left/right association is a general two-view
    problem. Here: extract on the raw fisheye images, undistort keypoint
    coordinates to each camera's ideal pinhole frame, match L<->R with a
    descriptor + epipolar gate from the rig extrinsics `T_rl` (maps
    LEFT-camera coords to RIGHT-camera coords), and DLT-triangulate each
    match. The triangulated depth becomes a virtual disparity
    (u_r = u - bf/z) so the entire downstream stereo machinery — GN
    stereo residuals, BA, landmark creation — runs unchanged (the same
    trick as the reference's ComputeStereoFromRGBD).

    Lines are mono-only on this path: the reference's fisheye frame is
    points-only too (no LSD/line channel in the KB8 ctor).
    """
    import dataclasses as _dc

    from pli_slam_tpu.ops import camera as cam_ops
    from pli_slam_tpu.ops import matching
    from pli_slam_tpu.solve import triangulate as tri

    fl = orb.extract(img_l, cfg.orb)
    fr_ = orb.extract(img_r, cfg.orb)
    uv_l = undistort_uv(cam_l, fl.uv)
    uv_r = undistort_uv(cam_r, fr_.uv)
    fl = _dc.replace(fl, uv=uv_l)
    pin_l = _dc.replace(cam_l, model=0)  # PINHOLE
    pin_r = _dc.replace(cam_r, model=0)

    # epipolar gate from the rig geometry: left view T_cw = (I, 0),
    # right view T_cw = (R_rl, t_rl) in left-camera world
    eye = jnp.eye(3)
    zero = jnp.zeros(3)
    gate = tri.epipolar_gate(pin_l, eye, zero, R_rl, t_rl, uv_l, uv_r)
    dist = matching.hamming_matrix(fl.desc, fr_.desc)
    idx, best, ok = matching.match_nn(
        dist, fl.valid, fr_.valid, gate,
        max_dist=cfg.match.orb_th_high, ratio=cfg.match.nn_ratio,
    )
    ok = matching.mutual_consistency(idx, ok, dist, fl.valid, fr_.valid, gate)

    ray_l = cam_ops.unproject(pin_l, uv_l)
    ray_r = cam_ops.unproject(pin_r, uv_r[jnp.maximum(idx, 0)])
    X = tri.triangulate_dlt(eye, zero, R_rl, t_rl, ray_l, ray_r)
    good = tri.triangulation_checks(
        pin_l, eye, zero, R_rl, t_rl, X, uv_l, uv_r[jnp.maximum(idx, 0)],
        fl.scale ** 2, fr_.scale[jnp.maximum(idx, 0)] ** 2,
        min_parallax_cos=1.0,  # the fixed rig baseline IS the parallax
    )
    z = X[:, 2]
    depth = jnp.where(ok & good & (z > 0.05), z, -1.0)
    sok = depth > 0
    u_r = jnp.where(sok, uv_l[:, 0] - cam_l.bf / jnp.maximum(depth, 1e-6), -1.0)

    if cfg.use_lines:
        ll = line_ops.detect(img_l, cfg.lines)
        ll = _dc.replace(ll, p0=undistort_uv(cam_l, ll.p0), p1=undistort_uv(cam_l, ll.p1))
    else:
        ll = _empty_lines(cfg)
    nl = cfg.lines.n_lines
    return FrameData(
        feats=fl, u_right=u_r, stereo_ok=sok, depth=depth,
        lines=ll, line_disp=jnp.zeros((nl, 2)), line_ok=jnp.zeros(nl, bool),
        sigma2=fl.scale ** 2,
    )


def make_build_frame(cam: Camera, cfg: SlamConfig):
    """Jitted frame builder with camera/config closed over."""
    return jax.jit(partial(build_frame, cam, cfg))


def make_build_frame_rgbd(cam: Camera, cfg: SlamConfig):
    return jax.jit(partial(build_frame_rgbd, cam, cfg))


def make_build_frame_mono(cam: Camera, cfg: SlamConfig):
    return jax.jit(partial(build_frame_mono, cam, cfg))
