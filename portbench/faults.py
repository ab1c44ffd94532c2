"""The control and the faults that the checks of `correct` must catch.

`--fault <name>` installs one before set-up; the benchmark's own runs
install none. Each breaks the timed path underneath the harness:

* `control`: the reference in the data plane's place, repairing each lost
  block from k - 1 of its helpers (the guarantee "restored from k
  surviving blocks" broken);
* `round_noop`: every round's fold folds nothing: each group's first
  row is written, as it is, into the group's destination row;
* `scale_noop`: the premultiply scales every helper row by 1, so the
  rows it writes are the helper rows unscaled and a restored block is
  the XOR of its helpers;
* `half_batch`: half of each batch's stripes are left out, their blocks
  reported as zeros;
* `flip_byte`: one byte of each restored block is altered where the
  data plane produces it.

There is one card and one process, so no exchange between chips can be
left out.
"""
from __future__ import annotations

import types
from collections.abc import Callable

import numpy as np
import torch

from portbench import reference

NAMES = ("control", "round_noop", "scale_noop", "half_batch", "flip_byte")


def _control(plans, codes, codewords, *, block_of, device=None, **_):
    recon = []
    for b, pa in enumerate(plans):
        code = codes[b] if isinstance(codes, (list, tuple)) else codes
        cw, bmap = codewords[b], block_of[b]
        jobs = {}
        for j in range(pa.num_jobs):
            lost = int(bmap[pa.job_failed[j]])
            helpers = [int(bmap[h])
                       for h in pa.job_helpers[j, :int(pa.job_helpers_len[j])]]
            coeffs = reference.repair_coeffs(code.n, code.k, lost, helpers)
            jobs[int(pa.job_id[j])] = reference.combine(
                coeffs[:-1], [cw[h] for h in helpers[:-1]])
        recon.append(jobs)
    nbytes = codewords[0].shape[-1]
    moved = np.array([nbytes * int((pa.t_path_len - 1).sum()) for pa in plans])
    return types.SimpleNamespace(reconstructed=recon, bytes_moved=moved)


def install(name: str) -> Callable[[], None]:
    """Install fault `name` in the port's modules; returns its undo."""
    from repro_torch.core.engine import dataplane
    from repro_torch.kernels import ops

    execute = dataplane.execute_plans_batch
    fold, scale = ops.xor_reduce_segments, ops.gf256_scale_batch

    def half_batch(plans, codes, codewords, *, block_of, **kw):
        h = (len(plans) + 1) // 2
        if isinstance(codes, (list, tuple)):
            codes = codes[:h]
        out = execute(plans[:h], codes, codewords[:h], block_of=block_of[:h],
                      **kw)
        for pa, cw in zip(plans[h:], codewords[h:]):
            out.reconstructed.append({int(pa.job_id[j]): torch.zeros_like(cw[0])
                                      for j in range(pa.num_jobs)})
        out.bytes_moved = np.concatenate([out.bytes_moved,
                                          np.zeros(len(plans) - h, np.int64)])
        return out

    def flip_byte(*args, **kw):
        out = execute(*args, **kw)
        for jobs in out.reconstructed:
            for block in jobs.values():
                block[0] ^= 1
        return out

    patches = {
        "control": (dataplane, "execute_plans_batch", _control),
        "half_batch": (dataplane, "execute_plans_batch", half_batch),
        "flip_byte": (dataplane, "execute_plans_batch", flip_byte),
        "round_noop": (ops, "xor_reduce_segments",
                       lambda chunks, groups, *args, **kw: fold(
                           chunks, np.ascontiguousarray(np.asarray(groups)[:, :1]),
                           *args, **kw)),
        # every argument after the coefficients passes through, so the
        # fault holds for a premultiply that reads its rows through a table
        "scale_noop": (ops, "gf256_scale_batch",
                       lambda coeffs, *args, **kw: scale(
                           np.ones_like(np.asarray(coeffs, np.uint8)), *args,
                           **kw)),
    }
    module, attr, fn = patches[name]
    setattr(module, attr, fn)
    restore = {"execute_plans_batch": execute, "xor_reduce_segments": fold,
               "gf256_scale_batch": scale}[attr]
    return lambda: setattr(module, attr, restore)
