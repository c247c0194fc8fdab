"""PC-extraction checkpoint format.

Counterpart of ``audioeditingcode_tpu/editing/pcdata.py``, with the same
schema, so an extraction written by either package loads in the other: a
compressed .npz of stacked per-window arrays plus a JSON-encoded args
record. ``load_extraction`` returns 'eigdata' per timestep key (eigvec,
eigval, interm_eigvecs, interm_eigvals, it, ts, norm_factor) beside
corrs, in_corrs, in_norms, latents and xts.
"""

from __future__ import annotations

import json
from types import SimpleNamespace
from typing import Dict, List

import numpy as np


def step_timestep_key(timesteps, it) -> int:
    """Unique integer eigdata key for trajectory step ``it``.

    DDIM-family timesteps are distinct integer train timesteps, which key
    eigdata. Continuous-time schedules (Stable Audio: t = atan(sigma)*2/pi
    in (0, 1)) collapse under int(), so those key by the step index."""
    t = float(timesteps[int(it)])
    return int(t) if t == int(t) else int(it)


def save_extraction(
    path: str,
    args: dict,
    eig_ts: List[int],  # window timesteps (train-timestep values)
    eig_its: List[int],  # iteration indices within the run
    eig_vecs: np.ndarray,  # (W, n_ev, ...)
    eig_vals: np.ndarray,  # (W, n_ev)
    interm_vecs: np.ndarray,  # (W, n_snap, n_ev, ...)
    interm_vals: np.ndarray,  # (W, n_snap, n_ev)
    snapshot_iters: List[int],
    norm_factors: np.ndarray,  # (W,) sqrt(alpha_bar[t])
    corrs: np.ndarray,  # (W-1, n_ev) cross-timestep PC correlations
    in_corrs: np.ndarray,  # (W, iters-1, n_ev)
    in_norms: np.ndarray,  # (W, iters, n_ev)
    latents: np.ndarray,  # (S+1, 1, ...) [x_T, z_{T-1}, ..., z_0]
    xts: np.ndarray,  # (S+1, N, ...) deterministic trajectory
) -> None:
    np.savez_compressed(
        path,
        args_json=json.dumps(args, default=str),
        eig_ts=np.asarray(eig_ts, dtype=np.int64),
        eig_its=np.asarray(eig_its, dtype=np.int64),
        eig_vecs=np.asarray(eig_vecs, dtype=np.float32),
        eig_vals=np.asarray(eig_vals, dtype=np.float32),
        interm_vecs=np.asarray(interm_vecs, dtype=np.float32),
        interm_vals=np.asarray(interm_vals, dtype=np.float32),
        snapshot_iters=np.asarray(snapshot_iters, dtype=np.int64),
        norm_factors=np.asarray(norm_factors, dtype=np.float32),
        corrs=np.asarray(corrs, dtype=np.float32),
        in_corrs=np.asarray(in_corrs, dtype=np.float32),
        in_norms=np.asarray(in_norms, dtype=np.float32),
        latents=np.asarray(latents, dtype=np.float32),
        xts=np.asarray(xts, dtype=np.float32),
    )


def load_extraction(path: str) -> dict:
    if not path.endswith(".npz"):
        path = path + ".npz"
    z = np.load(path, allow_pickle=False)
    args = SimpleNamespace(**json.loads(str(z["args_json"])))
    eigdata: Dict[int, dict] = {}
    snaps = [int(i) for i in z["snapshot_iters"]]
    for w, t in enumerate(z["eig_ts"]):
        eigdata[int(t)] = {
            "eigvec": z["eig_vecs"][w],
            "eigval": z["eig_vals"][w],
            "interm_eigvecs": {s: z["interm_vecs"][w, j] for j, s in enumerate(snaps)},
            "interm_eigvals": {s: z["interm_vals"][w, j] for j, s in enumerate(snaps)},
            "it": int(z["eig_its"][w]),
            "ts": int(args.num_diffusion_steps) - int(z["eig_its"][w]),
            "norm_factor": float(z["norm_factors"][w]),
        }
    return {
        "eigdata": eigdata,
        "args": args,
        "corrs": z["corrs"],
        "in_corrs": z["in_corrs"],
        "in_norms": z["in_norms"],
        "latents": z["latents"],
        "xts": z["xts"],
        "eig_ts": z["eig_ts"],
        "eig_vecs": z["eig_vecs"],
        "eig_vals": z["eig_vals"],
    }
