"""IMU preintegration on the SO(3) manifold as a `lax.scan`.

JAX replacement for `IMU::Preintegrated` (reference:
src/ImuTypes.cc — `IntegrateNewMeasurement` :255-310 with its 9x9 A /
9x6 B covariance propagation and bias Jacobians JRg/JVg/JVa/JPg/JPa,
`Reintegrate` :246, bias-corrected getters `GetDeltaRotation/
Velocity/Position` :312-330) and of the midpoint-averaging drain loop
in `Tracking::PreintegrateIMU` (reference: src/Tracking.cc:1085-1195).

The measurement batch is a fixed-capacity padded array (mask selects
real samples), so one compiled scan serves every frame. All math is
float32; the state is kept well-conditioned because deltas are
relative to the frame start (never world-absolute).

State ordering in the covariance is (phi, v, p) — matching the
reference's A/B block layout.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from pli_slam_tpu.ops import lie
from pli_slam_tpu.utils.config import ImuConfig

_HI = jax.lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Preintegrated:
    """Preintegrated IMU deltas between two frames/keyframes."""

    dt: jax.Array  # [] total time
    dR: jax.Array  # [3,3]
    dV: jax.Array  # [3]
    dP: jax.Array  # [3]
    cov: jax.Array  # [9,9] covariance of (phi, v, p)
    # bias Jacobians (reference JRg, JVg, JVa, JPg, JPa)
    JRg: jax.Array  # [3,3] d(dR)/d(bg)
    JVg: jax.Array  # [3,3]
    JVa: jax.Array  # [3,3]
    JPg: jax.Array  # [3,3]
    JPa: jax.Array  # [3,3]
    bg: jax.Array  # [3] gyro bias used at integration time
    ba: jax.Array  # [3] accel bias used

    @staticmethod
    def identity() -> "Preintegrated":
        z3 = jnp.zeros(3)
        z33 = jnp.zeros((3, 3))
        return Preintegrated(
            dt=jnp.zeros(()),
            dR=jnp.eye(3),
            dV=z3,
            dP=z3,
            cov=jnp.zeros((9, 9)),
            JRg=z33, JVg=z33, JVa=z33, JPg=z33, JPa=z33,
            bg=z3, ba=z3,
        )


def identity_with_bias(bg: jax.Array, ba: jax.Array) -> Preintegrated:
    """Identity accumulator linearized at the CURRENT biases: composing
    onto it is exact (compose corrects the appended segment to the
    accumulator's linearization bias — an all-zero-bias identity would
    silently re-linearize every first segment at b=0)."""
    return dataclasses.replace(Preintegrated.identity(), bg=bg, ba=ba)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PreintStore:
    """Per-keyframe preintegration chain, device-resident.

    Slot k holds the composed factor spanning KF k-1 -> KF k (reference
    KeyFrame::mpImuPreintegrated, snapshotted from
    mpImuPreintegratedFromLastKF at KF creation, src/Tracking.cc:3599).
    Keeping the chain on device lets the fused stereo-inertial step
    write factors and gather VI-BA windows without any host sync, and
    the host reads it back only on the rare paths (IMU init, FIBA,
    merges)."""

    data: Preintegrated  # every leaf carries a leading [K] axis
    valid: jax.Array  # [K] bool

    @staticmethod
    def empty(capacity: int) -> "PreintStore":
        ident = Preintegrated.identity()
        data = jax.tree_util.tree_map(
            lambda x: jnp.zeros((capacity,) + x.shape, x.dtype) + x, ident
        )
        return PreintStore(data=data, valid=jnp.zeros(capacity, bool))

    def set(self, k, p: Preintegrated, valid=True) -> "PreintStore":
        data = jax.tree_util.tree_map(lambda A, x: A.at[k].set(x), self.data, p)
        return PreintStore(data=data, valid=self.valid.at[k].set(valid))

    def gather(self, idx) -> Preintegrated:
        return jax.tree_util.tree_map(lambda A: A[idx], self.data)

    def remap(self, kf_slots) -> "PreintStore":
        """Re-index through a merge's src->dst keyframe slot mapping
        (-1 = dropped). A chain factor spans KF k-1 -> k, so it survives
        only if both endpoints stayed adjacent in the merged map
        (reference MergeInertialBA keeps mpImuPreintegrated factors
        across the seam, src/Optimizer.cc:6858)."""
        K = self.valid.shape[0]
        slots = jnp.asarray(kf_slots, jnp.int32)
        if slots.shape[0] < K:
            slots = jnp.concatenate(
                [slots, jnp.full(K - slots.shape[0], -1, jnp.int32)]
            )
        prev = jnp.concatenate([jnp.full(1, -2, jnp.int32), slots[:-1]])
        keep = self.valid & (slots >= 1) & (prev == slots - 1)
        dst = jnp.clip(jnp.where(keep, slots, K - 1), 0, K - 1)

        def scat(A):
            m = keep.reshape((-1,) + (1,) * (A.ndim - 1))
            return jnp.zeros_like(A).at[dst].add(jnp.where(m, A, jnp.zeros_like(A)))

        data = jax.tree_util.tree_map(scat, self.data)
        valid = jnp.zeros(K, bool).at[dst].max(keep)
        return PreintStore(data=data, valid=valid)


def preintegrate(
    gyro: jax.Array,  # [T, 3] rad/s
    acc: jax.Array,  # [T, 3] m/s^2
    dts: jax.Array,  # [T] seconds per sample
    mask: jax.Array,  # [T] bool, True = real sample
    bg: jax.Array,  # [3] gyro bias
    ba: jax.Array,  # [3] accel bias
    cfg: ImuConfig,
) -> Preintegrated:
    """Integrate a padded batch of IMU samples (reference midpoint samples).

    Masked-out samples are replaced by dt=0 no-ops, so the scan length is
    static regardless of how many samples landed between two frames.
    """
    noise_g2 = (cfg.noise_gyro ** 2) * cfg.rate_hz  # discrete: sigma^2 / dt, folded below
    noise_a2 = (cfg.noise_acc ** 2) * cfg.rate_hz

    def step(state, inp):
        dR, dV, dP, cov, JRg, JVg, JVa, JPg, JPa, t = state
        w, a, dt, m = inp
        dt = jnp.where(m, dt, 0.0)
        w = w - bg
        a = a - ba

        # position/velocity update uses the *current* rotation (reference
        # updates dP/dV before composing the new dR)
        a_rot = lie._einsum("ij,j->i", dR, a)
        dP_new = dP + dV * dt + 0.5 * a_rot * dt * dt
        dV_new = dV + a_rot * dt

        dRi = lie.so3_exp(w * dt)
        Jr = lie.so3_right_jacobian(w * dt)
        a_hat = lie.hat(a)

        # covariance propagation (reference ImuTypes.cc:276-291):
        # state (phi, v, p); A is the transition, B maps (eta_g, eta_a)
        A = jnp.eye(9)
        A = A.at[0:3, 0:3].set(dRi.T)
        A = A.at[3:6, 0:3].set(-lie._mm(dR, a_hat) * dt)
        A = A.at[6:9, 0:3].set(-0.5 * lie._mm(dR, a_hat) * dt * dt)
        A = A.at[6:9, 3:6].set(jnp.eye(3) * dt)
        B = jnp.zeros((9, 6))
        B = B.at[0:3, 0:3].set(Jr * dt)
        B = B.at[3:6, 3:6].set(dR * dt)
        B = B.at[6:9, 3:6].set(0.5 * dR * dt * dt)
        Nga = jnp.zeros((6, 6))
        Nga = Nga.at[0:3, 0:3].set(jnp.eye(3) * noise_g2 * dt)
        Nga = Nga.at[3:6, 3:6].set(jnp.eye(3) * noise_a2 * dt)
        cov_new = lie._mm(lie._mm(A, cov), A.T) + lie._mm(lie._mm(B, Nga), B.T)

        # bias Jacobians (reference ImuTypes.cc:293-298)
        JPa_new = JPa + JVa * dt - 0.5 * dR * dt * dt
        JPg_new = JPg + JVg * dt - 0.5 * lie._mm(lie._mm(dR, a_hat), JRg) * dt * dt
        JVa_new = JVa - dR * dt
        JVg_new = JVg - lie._mm(lie._mm(dR, a_hat), JRg) * dt
        JRg_new = lie._mm(dRi.T, JRg) - Jr * dt

        dR_new = lie._mm(dR, dRi)
        return (dR_new, dV_new, dP_new, cov_new, JRg_new, JVg_new, JVa_new, JPg_new, JPa_new, t + dt), None

    init = (
        jnp.eye(3), jnp.zeros(3), jnp.zeros(3), jnp.zeros((9, 9)),
        jnp.zeros((3, 3)), jnp.zeros((3, 3)), jnp.zeros((3, 3)),
        jnp.zeros((3, 3)), jnp.zeros((3, 3)), jnp.zeros(()),
    )
    (dR, dV, dP, cov, JRg, JVg, JVa, JPg, JPa, t), _ = jax.lax.scan(
        step, init, (gyro, acc, dts, mask)
    )
    return Preintegrated(
        dt=t, dR=lie.normalize_rotation(dR), dV=dV, dP=dP, cov=cov,
        JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa, bg=bg, ba=ba,
    )


def delta_rotation(p: Preintegrated, bg: jax.Array) -> jax.Array:
    """Bias-corrected dR (reference GetDeltaRotation, ImuTypes.cc:312)."""
    return lie._mm(p.dR, lie.so3_exp(lie._einsum("ij,j->i", p.JRg, bg - p.bg)))


def delta_velocity(p: Preintegrated, bg: jax.Array, ba: jax.Array) -> jax.Array:
    return p.dV + lie._einsum("ij,j->i", p.JVg, bg - p.bg) + lie._einsum("ij,j->i", p.JVa, ba - p.ba)


def delta_position(p: Preintegrated, bg: jax.Array, ba: jax.Array) -> jax.Array:
    return p.dP + lie._einsum("ij,j->i", p.JPg, bg - p.bg) + lie._einsum("ij,j->i", p.JPa, ba - p.ba)


def compose(a: Preintegrated, b: Preintegrated) -> Preintegrated:
    """Merge two consecutive preintegrations (a, then b) into one.

    First-order exact in noise and bias: b's deltas are corrected to a's
    linearization bias via its own bias Jacobians, then chained. The
    reference instead stores the raw measurement stream and re-integrates
    (`IMU::Preintegrated::MergePrevious` / `Reintegrate`,
    src/ImuTypes.cc:226-253); composition gives the per-keyframe
    accumulator without keeping raw samples or a dynamic-length scan.

    Error-state convention matches `preintegrate`'s (phi, v, p) blocks
    with right-multiplicative rotation error.
    """
    dRb = delta_rotation(b, a.bg)
    dVb = delta_velocity(b, a.bg, a.ba)
    dPb = delta_position(b, a.bg, a.ba)
    dtb = b.dt
    dR = lie._mm(a.dR, dRb)
    dV = a.dV + lie._einsum("ij,j->i", a.dR, dVb)
    dP = a.dP + a.dV * dtb + lie._einsum("ij,j->i", a.dR, dPb)

    hVb = lie.hat(dVb)
    hPb = lie.hat(dPb)
    JRg = lie._mm(dRb.T, a.JRg) + b.JRg
    JVg = a.JVg - lie._mm(lie._mm(a.dR, hVb), a.JRg) + lie._mm(a.dR, b.JVg)
    JVa = a.JVa + lie._mm(a.dR, b.JVa)
    JPg = a.JPg + a.JVg * dtb - lie._mm(lie._mm(a.dR, hPb), a.JRg) + lie._mm(a.dR, b.JPg)
    JPa = a.JPa + a.JVa * dtb + lie._mm(a.dR, b.JPa)

    # covariance: T transports a's (phi, v, p) error across segment b;
    # S rotates b's own error into the composite frame
    I3 = jnp.eye(3)
    T = jnp.zeros((9, 9))
    T = T.at[0:3, 0:3].set(dRb.T)
    T = T.at[3:6, 0:3].set(-lie._mm(a.dR, hVb))
    T = T.at[3:6, 3:6].set(I3)
    T = T.at[6:9, 0:3].set(-lie._mm(a.dR, hPb))
    T = T.at[6:9, 3:6].set(I3 * dtb)
    T = T.at[6:9, 6:9].set(I3)
    S = jnp.zeros((9, 9))
    S = S.at[0:3, 0:3].set(I3)
    S = S.at[3:6, 3:6].set(a.dR)
    S = S.at[6:9, 6:9].set(a.dR)
    cov = lie._mm(lie._mm(T, a.cov), T.T) + lie._mm(lie._mm(S, b.cov), S.T)
    return Preintegrated(
        dt=a.dt + b.dt, dR=lie.normalize_rotation(dR), dV=dV, dP=dP, cov=cov,
        JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa, bg=a.bg, ba=a.ba,
    )


def predict_state(
    Rwb0: jax.Array, vw0: jax.Array, pw0: jax.Array,
    p: Preintegrated, bg: jax.Array, ba: jax.Array, gravity=9.81,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Dead-reckon body state across the preintegration window.

    `gravity` is a scalar magnitude (acts along world -z) or a world
    gravity vector [3]. (reference: Tracking::PredictStateIMU,
    src/Tracking.cc:1197-1249)
    """
    g = jnp.asarray(gravity)
    if g.ndim == 0:
        g = jnp.array([0.0, 0.0, -1.0]) * g
    dt = p.dt
    dR = delta_rotation(p, bg)
    dV = delta_velocity(p, bg, ba)
    dP = delta_position(p, bg, ba)
    Rwb1 = lie.normalize_rotation(lie._mm(Rwb0, dR))
    vw1 = vw0 + g * dt + lie._einsum("ij,j->i", Rwb0, dV)
    pw1 = pw0 + vw0 * dt + 0.5 * g * dt * dt + lie._einsum("ij,j->i", Rwb0, dP)
    return Rwb1, vw1, pw1


def midpoint_samples(
    gyro_raw: jax.Array, acc_raw: jax.Array, stamps: jax.Array, t0: jax.Array, t1: jax.Array, mask_raw: jax.Array
):
    """Average consecutive raw samples into midpoint measurements covering [t0, t1].

    Mirrors the drain loop in Tracking::PreintegrateIMU (reference:
    src/Tracking.cc:1142-1189) but padded/masked: input is [T] raw
    samples with validity mask; output is [T-1] midpoint samples with dt
    clipped to the frame interval.
    """
    g_mid = 0.5 * (gyro_raw[:-1] + gyro_raw[1:])
    a_mid = 0.5 * (acc_raw[:-1] + acc_raw[1:])
    seg_a = jnp.maximum(stamps[:-1], t0)
    seg_b = jnp.minimum(stamps[1:], t1)
    dts = jnp.maximum(seg_b - seg_a, 0.0)
    m = mask_raw[:-1] & mask_raw[1:] & (dts > 0)
    return g_mid, a_mid, dts, m
