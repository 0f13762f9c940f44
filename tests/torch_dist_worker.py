"""Rank processes for tests/test_torch_dist.py (not collected: no test_ prefix).

`start_ranks(world, cases, tmp_path)` starts `world` spawned processes
(`join_ranks` collects them); each joins one gloo process group
(blaze_tpu_torch.dist.init_distributed, through a file store under
tmp_path), runs the named cases on blaze_tpu_torch's sharded paths (CPU
tensors: the kernels' plain versions) and saves what it computed.  The
children import torch and blaze_tpu_torch only, never JAX: the test
process compares their outputs with the JAX package and the oracles.
"""
from __future__ import annotations

import multiprocessing as mp
import pickle
import time
from pathlib import Path

import numpy as np


def _words(a: np.ndarray):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def _msm(inp: dict) -> np.ndarray:
    from blaze_tpu_torch.curves import CURVES, Curve
    from blaze_tpu_torch.dist import DistributedMSM, make_mesh

    cv = Curve(CURVES[inp["curve"]])
    mesh = make_mesh(inp["mesh"], device_type="cpu")
    pts = cv.fq.to_mont(_words(inp["points"]))
    res = DistributedMSM(cv, mesh, axis="dp")(pts, _words(inp["scalars"]),
                                               window_bits=inp["window_bits"],
                                               scalar_bits=inp.get("scalar_bits"))
    return res.numpy().view(np.uint32)


def _ntt(inp: dict) -> dict:
    from blaze_tpu_torch.dist import DistributedNTT, make_mesh
    from blaze_tpu_torch.fields import FIELDS

    mesh = make_mesh(inp["mesh"], device_type="cpu")
    d = DistributedNTT(FIELDS[inp["field"]], inp["logn"], mesh, axis="sp", logn1=inp["logn1"])
    xk = d.ntt(_words(inp["x"]))
    return {"shard": xk.numpy().view(np.uint32),
            "natural": d.spectral_to_natural(xk).numpy().view(np.uint32),
            "back": d.intt(xk).numpy().view(np.uint32)}


def _run_dist(inp: dict) -> np.ndarray:
    from blaze_tpu_torch.curves import CURVES, Curve
    from blaze_tpu_torch.dist import make_mesh
    from blaze_tpu_torch.pipeline import ProofPipeline

    cv = Curve(CURVES[inp["curve"]])
    mesh = make_mesh(inp["mesh"], device_type="cpu")
    pipe = ProofPipeline(cv, inp["ntt_logn"], inp["msm_logn"], mesh=mesh)
    pts = cv.fq.to_mont(_words(inp["points"]))
    res = pipe.run_dist(_words(inp["coeffs"]), pts, window_bits=inp["window_bits"],
                        scalar_bits=inp.get("scalar_bits"), scalar_mask=inp.get("mask"))
    return res.numpy().view(np.uint32)


def _ragged(inp: dict) -> str:
    """The message of DistributedMSM's refusal of 6 points over the axis."""
    import torch

    from blaze_tpu_torch.curves import CURVES, Curve
    from blaze_tpu_torch.dist import DistributedMSM, make_mesh

    cv = Curve(CURVES[inp["curve"]])
    msm = DistributedMSM(cv, make_mesh(inp["mesh"], device_type="cpu"), axis="dp")
    W = cv.nwords
    try:
        msm(torch.zeros((6, 2, W), dtype=torch.int32), torch.zeros((6, 2 * W), dtype=torch.int32))
    except ValueError as e:
        return str(e)
    return "no error"


CASES = {"msm": _msm, "ntt": _ntt, "run_dist": _run_dist, "ragged": _ragged}


def _rank(rank: int, world: int, store: str, cases: dict, out: str) -> None:
    import torch
    import torch.distributed as dist

    from blaze_tpu_torch.dist import init_distributed

    torch.set_num_threads(1)
    # the JAX package's bootstrap signature, meeting through a file store
    init_distributed(f"file://{store}", world, rank, device_type="cpu")
    try:
        got = {name: CASES[inp["kind"]](inp) for name, inp in cases.items()}
    finally:
        dist.destroy_process_group()
    with open(Path(out) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(got, f)


def start_ranks(world: int, cases: dict, tmp_path: Path, timeout: float = 120.0) -> tuple:
    """Start `world` gloo ranks on `cases` ({name: input dict with "kind"});
    join them with `join_ranks`, which fails a group that has not finished
    `timeout` seconds after its start (a hung collective)."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, world, str(tmp_path / "store"), cases,
                                             str(tmp_path)))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, time.monotonic() + timeout, tmp_path, timeout


def join_ranks(group: tuple) -> list:
    """Each rank's {name: output} of a group from `start_ranks`; its ranks
    are killed if they have not finished by the group's deadline."""
    procs, deadline, tmp_path, timeout = group
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if hung:
        raise TimeoutError(f"ranks {hung} of {len(procs)} still running after {timeout} s")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"rank exit codes {codes}")
    out = []
    for r in range(len(procs)):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out
