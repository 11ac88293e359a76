"""Sliding-window state: W+1 frames as a NamedTuple of fixed-shape tensors.

Counterpart of `pose_estimation_tpu/models/window.py`. Frame 0 is the
marginalization anchor, frames 1..W are optimized; `ics[k]` connects frames
k and k+1. Updates return new tuples (the tensors are small).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vio_bench.ref.imu import preintegration as pre
from vio_bench.ref.imu.preintegration import ImuConstraint
from vio_bench.ref.utils import lie


class WindowState(NamedTuple):
    R: torch.Tensor            # [W+1, 3, 3] body->world
    v: torch.Tensor            # [W+1, 3]
    p: torch.Tensor            # [W+1, 3]
    dbg: torch.Tensor          # [W+1, 3]
    dba: torch.Tensor          # [W+1, 3]
    ics: ImuConstraint         # stacked [W, ...]
    is_keyframe: torch.Tensor  # bool scalar
    need_reinit: torch.Tensor  # bool scalar
    sum_imu_time: torch.Tensor
    n_act: torch.Tensor        # int32 scalar in [1, W]
    prior_h: torch.Tensor      # [15W, 15W]
    lin_R: torch.Tensor        # [W, 3, 3]
    lin_p: torch.Tensor        # [W, 3]
    lin_v: torch.Tensor
    lin_bg: torch.Tensor
    lin_ba: torch.Tensor
    prior_on: torch.Tensor     # bool scalar


def _empty_ic(w: int, device, dtype) -> ImuConstraint:
    def z(*s):
        return torch.zeros(s, dtype=dtype, device=device)

    eye = torch.eye(3, dtype=dtype, device=device).expand(w, 3, 3).clone()
    eye15 = torch.eye(15, dtype=dtype, device=device).expand(w, 15, 15).clone()
    return ImuConstraint(
        inv_cov=eye15, bg_i=z(w, 3), ba_i=z(w, 3), dR=eye, dv=z(w, 3),
        dp=z(w, 3), d_R_bg=z(w, 3, 3), d_v_bg=z(w, 3, 3), d_v_ba=z(w, 3, 3),
        d_p_bg=z(w, 3, 3), d_p_ba=z(w, 3, 3), dt=z(w), dt2=z(w),
    )


def init_window(w: int, device, dtype=torch.float32) -> WindowState:
    def z(*s):
        return torch.zeros(s, dtype=dtype, device=device)

    def eye3(n):
        return torch.eye(3, dtype=dtype, device=device).expand(n, 3, 3).clone()

    def flag(b):
        return torch.tensor(b, device=device)

    return WindowState(
        R=eye3(w + 1), v=z(w + 1, 3), p=z(w + 1, 3), dbg=z(w + 1, 3),
        dba=z(w + 1, 3), ics=_empty_ic(w, device, dtype),
        is_keyframe=flag(True), need_reinit=flag(False), sum_imu_time=z(),
        n_act=torch.tensor(w, dtype=torch.int32, device=device),
        prior_h=z(15 * w, 15 * w), lin_R=eye3(w), lin_p=z(w, 3),
        lin_v=z(w, 3), lin_bg=z(w, 3), lin_ba=z(w, 3), prior_on=flag(False),
    )


def _set_active(a: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    return torch.cat([a[:1], new], 0)


def apply_deltas(win: WindowState, delta_pose, delta_vdbga,
                 max_gyr_bias: float, max_acc_bias: float) -> WindowState:
    """Right-multiplicative solver-delta application (`Map::updateStates`)
    plus the bias-corruption check."""
    dr, dp = delta_pose[:, 0:3], delta_pose[:, 3:6]
    dv, ddbg, ddba = delta_vdbga[:, 0:3], delta_vdbga[:, 3:6], delta_vdbga[:, 6:9]
    R_act = win.R[1:]
    new_dbg = win.dbg[1:] + ddbg
    new_dba = win.dba[1:] + ddba
    updated_bg = win.ics.bg_i[-1] + new_dbg[-1]
    updated_ba = win.ics.ba_i[-1] + new_dba[-1]
    need_reinit = (torch.linalg.norm(updated_bg) > max_gyr_bias) | (
        torch.linalg.norm(updated_ba) > max_acc_bias
    )
    return win._replace(
        R=_set_active(win.R, R_act @ lie.so3_exp(dr)),
        p=_set_active(win.p, win.p[1:] + lie.mv(R_act, dp)),
        v=_set_active(win.v, win.v[1:] + dv),
        dbg=_set_active(win.dbg, new_dbg),
        dba=_set_active(win.dba, new_dba),
        need_reinit=need_reinit,
    )


def check_keyframe(win: WindowState, min_rotation: float,
                   min_translation: float, max_imu_time: float) -> WindowState:
    """Keyframe test on the two newest frames (`Map::checkKeyframe`)."""
    R_i, p_i = win.R[-2], win.p[-2]
    R_j, p_j = win.R[-1], win.p[-1]
    dR = R_j @ R_i.T
    dp = p_j - lie.mv(dR, p_i)
    dr = lie.so3_log(dR)
    is_kf = (
        (torch.linalg.norm(dr) > min_rotation)
        | (torch.linalg.norm(dp) > min_translation)
        | (win.sum_imu_time > max_imu_time)
    )
    return win._replace(
        is_keyframe=is_kf,
        sum_imu_time=torch.where(
            is_kf, torch.zeros_like(win.sum_imu_time), win.sum_imu_time
        ),
    )


def _roll_set_last(a: torch.Tensor, last: torch.Tensor, kf) -> torch.Tensor:
    """Keyframe: shift left by one and put `last` in the newest slot; else
    overwrite the newest slot."""
    shifted = torch.cat([a[1:], last[None]], 0)
    kept = torch.cat([a[:-1], last[None]], 0)
    return torch.where(kf, shifted, kept)


def push_constraint(win: WindowState, ic_new: ImuConstraint, gravity) -> WindowState:
    """Append (after a keyframe) or re-predict (otherwise) the newest frame
    from the IMU constraint (`Map::pushImuConstraint`), with no host read.
    The keyframe's prediction is computed on every frame; the re-predict,
    the dearer side (a bias-corrected rotation), is a `graphs.cond`: an IF
    node that a keyframe skips in a captured graph, a select eagerly and
    under `vmap`."""
    # imported here: graphs imports the models, which import this module
    from vio_bench.ref import graphs

    kf = win.is_keyframe
    wsize = win.R.shape[0] - 1
    # keyframe: predict from the last keyframe (slot W, before the roll)
    # with the raw deltas; else from slot W-1 with the bias-corrected ones
    predicted = pre.predict(win.R[-1], win.v[-1], win.p[-1], ic_new, gravity)
    R_j, v_j, p_j = graphs.cond(~kf, lambda: pre.predict(
        win.R[-2], win.v[-2], win.p[-2], ic_new, gravity,
        dbg_i=win.dbg[-2], dba_i=win.dba[-2],
    ), predicted)
    zero3 = torch.zeros_like(win.dbg[-1])
    ics = ImuConstraint(*(
        _roll_set_last(a, n, kf) for a, n in zip(win.ics, ic_new)
    ))
    new_n_act = torch.where(
        kf, torch.clamp(win.n_act + 1, max=wsize), win.n_act
    ).to(torch.int32)
    return win._replace(
        R=_roll_set_last(win.R, R_j, kf),
        v=_roll_set_last(win.v, v_j, kf),
        p=_roll_set_last(win.p, p_j, kf),
        dbg=_roll_set_last(win.dbg, zero3, kf),
        dba=_roll_set_last(win.dba, zero3, kf),
        ics=ics,
        sum_imu_time=win.sum_imu_time + ic_new.dt,
        n_act=new_n_act,
    )
