"""Line-segment detection and LBD-style binary description, fully batched.

JAX replacement for the reference's vendored `line_descriptor`
fork — `LSDDetectorC::detect` (reference:
Thirdparty/line_descriptor/src/LSDDetector_custom.cpp:218-325) and the
LBD `BinaryDescriptor::compute` (reference:
Thirdparty/line_descriptor/src/binary_descriptor_custom.cpp) — and of
the thin `Lineextractor` wrapper (reference: src/LineExtractor.cc:31-70).

LSD's region-growing is inherently sequential, so the detector is
re-designed for XLA (SURVEY.md §7.3 item 2):

1. Sobel gradients -> Canny-style directional NMS edge map.
2. Gradient-guided Hough voting: each edge pixel votes only into the
   ~3 theta bins normal to its own gradient (scatter-add), so the
   accumulator costs O(3·edges), not O(edges · n_theta).
3. Peak NMS + top-K gives candidate infinite lines.
4. Each candidate is rasterized at S fixed samples; per-sample support
   = magnitude + angular agreement; the longest gap-closed support run
   (a batched scan) yields segment endpoints.
5. Matrix NMS dedups near-collinear segments; top-N by score.

The descriptor samples a 9-band x 7-row x S-column support grid of
(parallel, perpendicular) gradient projections, reduces band means and
stds (the LBD statistic), and binarizes the 72-dim vector with a fixed
seeded random projection into 256 bits (±1 int8) so line matching
reuses the same int8-matmul Hamming kernel as points.

Output is a fixed-capacity padded `LineFeatures` with a validity mask.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from pli_slam_tpu.ops import image as image_ops
from pli_slam_tpu.utils.config import LineConfig


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LineFeatures:
    """Padded line-segment set in pixel coordinates."""

    p0: jax.Array  # [N, 2] float32 endpoint (x, y)
    p1: jax.Array  # [N, 2] float32 endpoint
    angle: jax.Array  # [N] float32 segment direction in [-pi/2, pi/2)
    length: jax.Array  # [N] float32 pixels
    response: jax.Array  # [N] float32 mean gradient magnitude
    desc: jax.Array  # [N, 256] int8 ±1 LBD-projection bits
    valid: jax.Array  # [N] bool

    @property
    def capacity(self) -> int:
        return self.p0.shape[0]

    def count(self) -> jax.Array:
        return jnp.sum(self.valid.astype(jnp.int32))

    def midpoint(self) -> jax.Array:
        return 0.5 * (self.p0 + self.p1)

    def line_coeffs(self) -> jax.Array:
        """Normalized homogeneous line coefficients l = p0 x p1, [N, 3]."""
        h0 = jnp.concatenate([self.p0, jnp.ones_like(self.p0[:, :1])], axis=1)
        h1 = jnp.concatenate([self.p1, jnp.ones_like(self.p1[:, :1])], axis=1)
        l = jnp.cross(h0, h1)
        n = jnp.linalg.norm(l[:, :2], axis=1, keepdims=True)
        return l / jnp.maximum(n, 1e-9)


# ---------------------------------------------------------------------------
# Detection
# ---------------------------------------------------------------------------


def _edge_map(img: jax.Array, grad_threshold: float):
    """Directional-NMS edge mask + gradients (Canny-thin, batched)."""
    blurred = image_ops.gaussian_blur(img, sigma=1.0, radius=2)
    gx, gy = image_ops.sobel_gradients(blurred)
    mag = jnp.sqrt(gx * gx + gy * gy)
    # quantize gradient direction into 4 sectors; compare against both
    # neighbors along the gradient. Selection is a one-hot sum over the
    # 4 shifted maps — pure elementwise instead of a take_along_axis
    # gather (a design choice not yet measured on the card).
    ang = jnp.arctan2(gy, gx)  # [-pi, pi]
    sector = jnp.round(ang / (jnp.pi / 4.0)).astype(jnp.int32) % 4  # 0:E,1:NE,2:N,3:NW
    offs = [(0, 1), (1, 1), (1, 0), (1, -1)]  # (dy, dx) per sector
    sel_p = jnp.zeros_like(mag)
    sel_m = jnp.zeros_like(mag)
    for s, (dy, dx) in enumerate(offs):
        is_s = sector == s
        sel_p = jnp.where(is_s, jnp.roll(mag, (-dy, -dx), (0, 1)), sel_p)
        sel_m = jnp.where(is_s, jnp.roll(mag, (dy, dx), (0, 1)), sel_m)
    edge = (mag >= grad_threshold) & (mag >= sel_p) & (mag >= sel_m)
    h, w = img.shape
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    border = (ys >= 2) & (ys < h - 2) & (xs >= 2) & (xs < w - 2)
    return edge & border, gx, gy, mag


def _hough_vote(edge, gx, gy, mag, cfg: LineConfig, h: int, w: int):
    """Gradient-guided Hough accumulator [T, R] and its bin geometry.

    Votes are compacted to the strongest `n_voters` edge pixels first —
    scattering all H*W pixels (most with zero weight) cost ~3 ms/image;
    after compaction the three scatters touch ~32k rows.
    """
    T = cfg.theta_bins
    diag = math.hypot(h, w)
    R = int(2 * diag / cfg.rho_res) + 3
    # voter compaction: strongest edge pixel per small block instead of a
    # global top-k over H*W (the block-max reshape is cheaper, not yet
    # measured on the card, and spreads voters spatially, which Hough
    # prefers anyway)
    by, bx = 2, 2
    hp = h // by * by
    wp = w // bx * bx
    score2 = jnp.where(edge, mag, 0.0)[:hp, :wp]
    blocks = score2.reshape(hp // by, by, wp // bx, bx).transpose(0, 2, 1, 3).reshape(
        hp // by, wp // bx, by * bx
    )
    arg = jnp.argmax(blocks, axis=-1).astype(jnp.int32)
    bweight = jnp.max(blocks, axis=-1).reshape(-1)
    cy = jax.lax.broadcasted_iota(jnp.int32, arg.shape, 0) * by + arg // bx
    cx = jax.lax.broadcasted_iota(jnp.int32, arg.shape, 1) * bx + arg % bx
    bidx = (cy * w + cx).reshape(-1)
    # then a (now 4x smaller) top-k bounds the scatter-add volume
    n_voters = min(cfg.n_voters, bweight.shape[0])
    weight, sel = jax.lax.top_k(bweight, n_voters)
    flat_idx = bidx[sel]
    xs = (flat_idx % w).astype(jnp.float32)
    ys = (flat_idx // w).astype(jnp.float32)
    gx_v = gx.reshape(-1)[flat_idx]
    gy_v = gy.reshape(-1)[flat_idx]
    # line normal direction = gradient direction; theta in [0, pi)
    theta = jnp.arctan2(gy_v, gx_v) % jnp.pi
    tbin0 = (theta * (T / jnp.pi)).astype(jnp.int32) % T
    acc = jnp.zeros(T * R, jnp.float32)
    for dt in (-1, 0, 1):
        tb = (tbin0 + dt) % T
        th = (tb.astype(jnp.float32) + 0.5) * (jnp.pi / T)
        rho = xs * jnp.cos(th) + ys * jnp.sin(th)
        rbin = jnp.clip(((rho + diag) / cfg.rho_res).astype(jnp.int32), 0, R - 1)
        acc = acc.at[tb * R + rbin].add(weight)
    return acc.reshape(T, R), diag, R


def _hough_peaks(acc: jax.Array, k: int):
    """3x3 NMS + top-k over the accumulator -> (theta_idx, rho_idx, score)."""
    m = jax.lax.reduce_window(acc, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME")
    peaks = jnp.where((acc >= m) & (acc > 0), acc, 0.0).reshape(-1)
    score, idx = jax.lax.top_k(peaks, k)
    R = acc.shape[1]
    return idx // R, idx % R, score


def _longest_run(support: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Longest True run per row of [K, S] -> (start_idx, end_idx) inclusive.

    Returns start=end=0 when no support.
    """
    # run-length recurrence f[i] = (f[i-1] + 1) * x[i] is affine
    # (f = a*f_prev + b with a = b = x), so it composes associatively:
    # log2(S) depth instead of an S-step sequential scan.
    x = support.astype(jnp.int32)

    def compose(left, right):
        a1, b1 = left
        a2, b2 = right
        return a1 * a2, a2 * b1 + b2

    a, b = jax.lax.associative_scan(compose, (x, x), axis=1)
    runs = b  # [K, S] run length ending at i (f0 = 0)
    end = jnp.argmax(runs, axis=1).astype(jnp.int32)
    length = jnp.take_along_axis(runs, end[:, None], axis=1)[:, 0]
    start = end - jnp.maximum(length - 1, 0)
    return start, end


def _close_gaps(support: jax.Array, gap: int) -> jax.Array:
    """Morphological closing along the sample axis (fill gaps <= gap)."""
    if gap <= 0:
        return support
    x = support.astype(jnp.float32)[:, None, :, None]
    win = (1, 1, gap + 1, 1)
    dil = jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, win, (1, 1, 1, 1), "SAME")
    ero = -jax.lax.reduce_window(-dil, -jnp.inf, jax.lax.max, win, (1, 1, 1, 1), "SAME")
    return (ero[:, 0, :, 0] > 0.5) & (dil[:, 0, :, 0] > 0.5) | support


def detect(img: jax.Array, cfg: LineConfig, with_desc: bool = True) -> LineFeatures:
    """Detect up to cfg.n_lines segments in a [H, W] float32 image.

    `with_desc=False` skips the LBD descriptor (zeros) — the RIGHT
    stereo image only feeds endpoint-disparity association, which the
    geometric matcher (match_stereo_lines_geom) resolves without
    descriptors; skipping the right LBD saves its gather cost per frame.
    """
    h, w = img.shape
    edge, gx, gy, mag = _edge_map(img, cfg.grad_threshold)
    acc, diag, R = _hough_vote(edge, gx, gy, mag, cfg, h, w)
    t_idx, r_idx, peak_score = _hough_peaks(acc, cfg.n_candidates)

    T = cfg.theta_bins
    theta = (t_idx.astype(jnp.float32) + 0.5) * (jnp.pi / T)
    rho = (r_idx.astype(jnp.float32) + 0.5) * cfg.rho_res - diag
    ct, st = jnp.cos(theta), jnp.sin(theta)
    # param: point(t) = rho*(ct, st) + t*(-st, ct); find t-range inside image
    px, py = rho * ct, rho * st
    big = jnp.float32(1e9)

    def axis_range(p, d, lo, hi):
        t0 = (lo - p) / jnp.where(jnp.abs(d) < 1e-9, 1e-9, d)
        t1 = (hi - p) / jnp.where(jnp.abs(d) < 1e-9, 1e-9, d)
        tmin = jnp.where(jnp.abs(d) < 1e-6, -big, jnp.minimum(t0, t1))
        tmax = jnp.where(jnp.abs(d) < 1e-6, big, jnp.maximum(t0, t1))
        return tmin, tmax

    tx0, tx1 = axis_range(px, -st, 0.0, w - 1.0)
    ty0, ty1 = axis_range(py, ct, 0.0, h - 1.0)
    t_min = jnp.maximum(tx0, ty0)
    t_max = jnp.minimum(tx1, ty1)
    span = jnp.maximum(t_max - t_min, 0.0)

    S = cfg.n_samples
    ts = t_min[:, None] + (jnp.arange(S, dtype=jnp.float32)[None, :] + 0.5) / S * span[:, None]
    sx = px[:, None] - st[:, None] * ts
    sy = py[:, None] + ct[:, None] * ts
    # The support test needs only (a) "is this a strong-enough edge" and
    # (b) "is the gradient ~normal to the candidate line". Pre-encode
    # both into ONE small int map and do a single nearest gather per
    # sample — raw per-pixel gathers were the dominant cost here.
    n_obins = 32
    obin = jnp.floor((jnp.arctan2(gy, gx) % jnp.pi) * (n_obins / jnp.pi)).astype(jnp.int32)
    obin = jnp.clip(obin, 0, n_obins - 1)
    mag_level = jnp.clip(jnp.round(mag / cfg.grad_threshold * 8.0), 0, 63).astype(jnp.int32)
    code = obin + n_obins * mag_level  # [H, W] int32: orientation + coarse magnitude
    xi = jnp.clip(jnp.round(sx).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(jnp.round(sy).astype(jnp.int32), 0, h - 1)
    code_s = code[yi, xi]  # [K, S] single gather
    obin_s = code_s % n_obins
    m_s = (code_s // n_obins).astype(jnp.float32) * (cfg.grad_threshold / 8.0)
    strong_s = code_s >= 4 * n_obins  # mag >= 0.5 * grad_threshold
    tbin_line = jnp.floor(theta * (n_obins / jnp.pi)).astype(jnp.int32) % n_obins
    d_bin = jnp.abs(obin_s - tbin_line[:, None])
    d_bin = jnp.minimum(d_bin, n_obins - d_bin)
    tol_bins = max(int(round(cfg.support_angle_deg / (180.0 / n_obins))), 1)
    support = strong_s & (d_bin <= tol_bins)
    support = support & (span[:, None] > 0)
    support = _close_gaps(support, cfg.max_gap)

    s0, s1 = _longest_run(support)
    step_len = span / S
    t0 = t_min + (s0.astype(jnp.float32) + 0.5) * step_len
    t1 = t_min + (s1.astype(jnp.float32) + 0.5) * step_len
    p0 = jnp.stack([px - st * t0, py + ct * t0], axis=-1)
    p1 = jnp.stack([px - st * t1, py + ct * t1], axis=-1)
    length = jnp.abs(t1 - t0)

    # response: mean magnitude over the chosen run
    in_run = (jnp.arange(S)[None, :] >= s0[:, None]) & (jnp.arange(S)[None, :] <= s1[:, None])
    resp = jnp.sum(jnp.where(in_run, m_s, 0.0), axis=1) / jnp.maximum(
        jnp.sum(in_run, axis=1), 1
    )

    min_len = cfg.min_length_frac * min(h, w)
    valid = (length >= min_len) & (peak_score > 0)

    # matrix NMS of near-collinear duplicates: suppress a segment if a
    # higher-scoring one lies on nearly the same infinite line with
    # overlapping extent
    score = jnp.where(valid, length * (1.0 + 0.01 * resp), -1.0)
    mid = 0.5 * (p0 + p1)
    d_theta = jnp.abs(theta[:, None] - theta[None, :])
    d_theta = jnp.minimum(d_theta, jnp.pi - d_theta)
    # perpendicular distance of midpoint_i to line_j
    nx, ny = ct, st
    perp = jnp.abs(mid[:, None, 0] * nx[None, :] + mid[:, None, 1] * ny[None, :] - rho[None, :])
    similar = (d_theta < jnp.deg2rad(4.0)) & (perp < 3.0 * cfg.rho_res)
    higher = (score[None, :] > score[:, None]) | (
        (score[None, :] == score[:, None]) & (jnp.arange(score.shape[0])[None, :] < jnp.arange(score.shape[0])[:, None])
    )
    suppressed = jnp.any(similar & higher & valid[None, :], axis=1)
    valid = valid & ~suppressed

    # top-N by score into the fixed capacity
    final_score = jnp.where(valid, score, -1.0)
    top_s, top_i = jax.lax.top_k(final_score, cfg.n_lines)
    p0 = p0[top_i]
    p1 = p1[top_i]
    length = length[top_i]
    resp = resp[top_i]
    valid = (top_s > 0)
    seg_angle = jnp.arctan2(p1[:, 1] - p0[:, 1], p1[:, 0] - p0[:, 0])

    if with_desc:
        desc = lbd_descriptor(img, p0, p1, valid, cfg)
    else:
        desc = jnp.zeros((p0.shape[0], 256), jnp.int8)
    return LineFeatures(
        p0=p0, p1=p1, angle=seg_angle, length=length, response=resp, desc=desc, valid=valid
    )


# ---------------------------------------------------------------------------
# LBD descriptor
# ---------------------------------------------------------------------------

_PROJ_SEED = 7


def _projection_matrix(dim_in: int, dim_out: int = 256) -> np.ndarray:
    rng = np.random.default_rng(_PROJ_SEED)
    return rng.normal(size=(dim_in, dim_out)).astype(np.float32)


def lbd_descriptor(img: jax.Array, p0: jax.Array, p1: jax.Array, valid: jax.Array, cfg: LineConfig) -> jax.Array:
    """LBD band statistics + random-projection binarization -> ±1 int8 [N, 256].

    Math follows the Line Band Descriptor: the line support region is
    split into `n_bands` bands parallel to the line; per band the mean
    and std over columns of 4 half-wave gradient sums (g⊥+, g⊥-, g∥+,
    g∥-) form the descriptor (reference: binary_descriptor_custom.cpp
    `computeLBD`), here binarized by a fixed Gaussian projection.
    """
    blurred = image_ops.gaussian_blur(img, sigma=1.0, radius=2)
    gx, gy = image_ops.sobel_gradients(blurred)

    n = p0.shape[0]
    B = cfg.n_bands
    Wb = cfg.band_width
    S = cfg.lbd_samples

    d = p1 - p0
    length = jnp.linalg.norm(d, axis=-1, keepdims=True)
    dn = d / jnp.maximum(length, 1e-6)  # unit direction [N,2]
    nn = jnp.stack([-dn[:, 1], dn[:, 0]], axis=-1)  # unit normal

    ts = (jnp.arange(S, dtype=jnp.float32) + 0.5) / S  # along-line fractions
    half = (B * Wb - 1) / 2.0
    # sample band rows at stride 3 (the random gather is the dominant
    # cost of the descriptor; band statistics are insensitive to
    # third-density row sampling — measured descriptor-stability and
    # retrieval tests hold at this density)
    rows_per_band = -(-Wb // 3)
    row_in_band = np.arange(0, Wb, 3, dtype=np.float32)
    offs = jnp.asarray(
        (np.arange(B, dtype=np.float32)[:, None] * Wb + row_in_band[None, :]).reshape(-1)
        - half
    )  # [B * rows_per_band] perpendicular offsets

    base = p0[:, None, :] + d[:, None, :] * ts[None, :, None]  # [N,S,2]
    uv = base[:, :, None, :] + nn[:, None, None, :] * offs[None, None, :, None]  # [N,S,BW,2]
    # one fused nearest gather over the stacked [H, W, 2] gradient map —
    # both channels come back from a single slice per sample (4x fewer
    # random accesses than two bilinear samples)
    G = jnp.stack([gx, gy], axis=-1)
    himg, wimg = gx.shape
    xi = jnp.clip(jnp.round(uv[..., 0]).astype(jnp.int32), 0, wimg - 1)
    yi = jnp.clip(jnp.round(uv[..., 1]).astype(jnp.int32), 0, himg - 1)
    g_s = G[yi, xi]  # [N,S,BW,2]
    gx_s = g_s[..., 0]
    gy_s = g_s[..., 1]
    g_par = gx_s * dn[:, None, None, 0] + gy_s * dn[:, None, None, 1]
    g_perp = gx_s * nn[:, None, None, 0] + gy_s * nn[:, None, None, 1]

    # global Gaussian weight over perpendicular distance (classic LBD f_g)
    sigma_g = half / 2.0 + 1e-6
    wg = jnp.exp(-0.5 * (offs / sigma_g) ** 2)[None, None, :]

    feats = jnp.stack(
        [
            jnp.maximum(g_perp, 0.0) * wg,
            jnp.maximum(-g_perp, 0.0) * wg,
            jnp.maximum(g_par, 0.0) * wg,
            jnp.maximum(-g_par, 0.0) * wg,
        ],
        axis=-1,
    )  # [N, S, B*rows_per_band, 4]
    bands = feats.reshape(n, S, B, rows_per_band, 4).sum(axis=3)  # [N, S, B, 4]
    mean = bands.mean(axis=1)  # [N, B, 4]
    std = bands.std(axis=1)
    vec = jnp.concatenate([mean, std], axis=-1).reshape(n, B * 8)  # [N, 72]
    vec = vec / jnp.maximum(jnp.linalg.norm(vec, axis=-1, keepdims=True), 1e-6)

    proj = jnp.asarray(_projection_matrix(B * 8))
    bits = jnp.einsum("nf,fo->no", vec, proj, precision=jax.lax.Precision.HIGHEST) >= 0
    desc = jnp.where(bits, jnp.int8(1), jnp.int8(-1))
    return jnp.where(valid[:, None], desc, jnp.int8(0))


# ---------------------------------------------------------------------------
# Stereo line matching (endpoint disparity)
# ---------------------------------------------------------------------------


def vertical_overlap(l0: LineFeatures, l1: LineFeatures) -> jax.Array:
    """Pairwise y-overlap ratio [N0, N1] (reference lineSegmentOverlapStereo,
    src/Frame.cc:1261)."""
    y0min = jnp.minimum(l0.p0[:, 1], l0.p1[:, 1])[:, None]
    y0max = jnp.maximum(l0.p0[:, 1], l0.p1[:, 1])[:, None]
    y1min = jnp.minimum(l1.p0[:, 1], l1.p1[:, 1])[None, :]
    y1max = jnp.maximum(l1.p0[:, 1], l1.p1[:, 1])[None, :]
    inter = jnp.maximum(jnp.minimum(y0max, y1max) - jnp.maximum(y0min, y1min), 0.0)
    shorter = jnp.maximum(jnp.minimum(y0max - y0min, y1max - y1min), 1e-6)
    return inter / shorter


def match_stereo_lines(
    left: LineFeatures,
    right: LineFeatures,
    max_dist: float = 60.0,
    min_disparity: float = 0.1,
    max_disparity: float = 192.0,
    min_overlap: float = 0.5,
    max_angle_diff_deg: float = 10.0,
):
    """Match left->right lines and compute per-endpoint disparities.

    Per matched pair the left endpoints' image rows are intersected with
    the right line (reference: src/Frame.cc:1228-1230), then filtered by
    the endpoint-disparity ratio (reference filterLineSegmentDisparity,
    src/Frame.cc:1297).

    Returns (disp0 [N], disp1 [N], idx_r [N], ok [N]) aligned with left slots.
    """
    from pli_slam_tpu.ops import matching

    dist = matching.hamming_matrix(left.desc, right.desc)
    da = jnp.abs(left.angle[:, None] - right.angle[None, :])
    da = jnp.minimum(da, 2 * jnp.pi - da)
    da = jnp.minimum(da, jnp.pi - da)  # direction sign-agnostic
    gate = (da <= jnp.deg2rad(max_angle_diff_deg)) & (
        vertical_overlap(left, right) >= min_overlap
    )
    idx_r, best, ok = matching.match_nn(dist, left.valid, right.valid, gate, max_dist=max_dist)
    ok = matching.mutual_consistency(idx_r, ok, dist, left.valid, right.valid, gate)

    lr = right.line_coeffs()[idx_r]  # [N, 3] (a, b, c)
    a, b, c = lr[:, 0], lr[:, 1], lr[:, 2]
    # right line must not be near-horizontal (unstable intersection)
    stable = jnp.abs(a) > 0.05

    def xr_at(y):
        return -(c + b * y) / jnp.where(jnp.abs(a) < 1e-6, 1e-6, a)

    d0 = left.p0[:, 0] - xr_at(left.p0[:, 1])
    d1 = left.p1[:, 0] - xr_at(left.p1[:, 1])
    ratio = jnp.minimum(d0, d1) / jnp.maximum(jnp.maximum(d0, d1), 1e-6)
    ok = (
        ok
        & stable
        & (d0 > min_disparity) & (d1 > min_disparity)
        & (d0 < max_disparity) & (d1 < max_disparity)
        & (ratio > 0.6)
    )
    return d0, d1, idx_r, ok


def match_stereo_lines_geom(
    left: LineFeatures,
    right: LineFeatures,
    img_l: jax.Array,
    img_r: jax.Array,
    min_disparity: float = 0.1,
    max_disparity: float = 192.0,
    min_overlap: float = 0.5,
    max_angle_diff_deg: float = 10.0,
    n_verify: int = 16,
    verify_tol: float = 24.0,
):
    """Descriptor-free stereo line association for RECTIFIED pairs.

    The right image's lines need no LBD: after the epipolar gates
    (angle agreement, y-overlap, disparity range, endpoint-disparity
    ratio — the reference's own filters, src/Frame.cc:1156-1259) the
    residual ambiguity is parallel structure at different depth, which
    a photometric check resolves: sample the left segment's intensity
    at n_verify points and compare against the right image at the
    candidate's implied per-row disparity — a wrong parallel candidate
    implies the wrong disparity and lands off the structure.

    Returns (disp0 [N], disp1 [N], idx_r [N], ok [N]) aligned with left
    slots, same contract as match_stereo_lines.
    """
    # pairwise implied endpoint disparities from row intersection
    lr = right.line_coeffs()  # [M, 3]
    a, b, c = lr[:, 0], lr[:, 1], lr[:, 2]
    stable = jnp.abs(a) > 0.05

    def xr_at(y):  # [N] rows x [M] lines -> [N, M]
        return -(c[None, :] + b[None, :] * y[:, None]) / jnp.where(
            jnp.abs(a) < 1e-6, 1e-6, a
        )[None, :]

    d0p = left.p0[:, 0][:, None] - xr_at(left.p0[:, 1])  # [N, M]
    d1p = left.p1[:, 0][:, None] - xr_at(left.p1[:, 1])
    ratio = jnp.minimum(d0p, d1p) / jnp.maximum(jnp.maximum(d0p, d1p), 1e-6)

    da = jnp.abs(left.angle[:, None] - right.angle[None, :])
    da = jnp.minimum(da, 2 * jnp.pi - da)
    da = jnp.minimum(da, jnp.pi - da)
    ov = vertical_overlap(left, right)
    gate = (
        (da <= jnp.deg2rad(max_angle_diff_deg))
        & (ov >= min_overlap)
        & stable[None, :]
        & (d0p > min_disparity) & (d1p > min_disparity)
        & (d0p < max_disparity) & (d1p < max_disparity)
        & (ratio > 0.6)
        & left.valid[:, None] & right.valid[None, :]
    )
    # geometric ranking, then photometric verification of the TOP-2
    # candidates only (a full [N, M, S] pairwise intensity gather would
    # cost more than the LBD it replaces; two candidates cover the
    # dominant ambiguity — parallel structure at different depth)
    g_cost = jnp.where(gate, 2.0 * jnp.rad2deg(da) + 20.0 * (1.0 - ov), 1e9)
    c1 = jnp.argmin(g_cost, axis=1).astype(jnp.int32)
    g2 = g_cost.at[jnp.arange(g_cost.shape[0]), c1].set(1e9)
    c2 = jnp.argmin(g2, axis=1).astype(jnp.int32)
    cands = jnp.stack([c1, c2], axis=1)  # [N, 2]

    S = n_verify
    ts = (jnp.arange(S, dtype=jnp.float32) + 0.5) / S
    pl_ = left.p0[:, None, :] + (left.p1 - left.p0)[:, None, :] * ts[None, :, None]  # [N,S,2]
    h, w = img_l.shape
    xi = jnp.clip(jnp.round(pl_[..., 0]).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(jnp.round(pl_[..., 1]).astype(jnp.int32), 0, h - 1)
    I_l = img_l[yi, xi]  # [N, S]
    # implied right x at each sample row for the 2 candidates
    ac = a[cands]  # [N, 2]
    bc = b[cands]
    cc = c[cands]
    xr = -(cc[..., None] + bc[..., None] * pl_[..., 1][:, None, :]) / jnp.where(
        jnp.abs(ac) < 1e-6, 1e-6, ac
    )[..., None]  # [N, 2, S]
    xri = jnp.clip(jnp.round(xr).astype(jnp.int32), 0, w - 1)
    I_r = img_r[yi[:, None, :], xri]  # [N, 2, S]
    photo = jnp.mean(jnp.abs(I_l[:, None, :] - I_r), axis=-1)  # [N, 2]
    g_top = jnp.take_along_axis(g_cost, cands, axis=1)  # [N, 2]
    total = jnp.where(g_top < 1e8, photo + 0.5 * g_top, 1e9)
    pick = jnp.argmin(total, axis=1)
    idx_r = jnp.take_along_axis(cands, pick[:, None], axis=1)[:, 0]
    best = jnp.take_along_axis(total, pick[:, None], axis=1)[:, 0]
    best_photo = jnp.take_along_axis(photo, pick[:, None], axis=1)[:, 0]
    ok = (best < 1e8) & (best_photo < verify_tol)
    # mutual consistency on the geometric cost: no two left lines may
    # claim the same right line unless one dominates
    back = jnp.argmin(jnp.where(gate, g_cost, 1e9), axis=0).astype(jnp.int32)
    ok = ok & (back[idx_r] == jnp.arange(g_cost.shape[0]))
    d0 = jnp.take_along_axis(d0p, idx_r[:, None], axis=1)[:, 0]
    d1 = jnp.take_along_axis(d1p, idx_r[:, None], axis=1)[:, 0]
    return d0, d1, idx_r, ok
