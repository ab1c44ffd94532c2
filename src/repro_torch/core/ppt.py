"""PPT — Parallel Pipeline Tree (Bai et al., ICPP'19) baseline.

PPT builds, *once, from the bandwidth snapshot at repair start*, a tree
rooted at the requestor spanning the k helpers; chunk slices are pipelined
down the tree, so steady-state repair rate = the tree's bottleneck edge
rate. PPT assumes a receiver's capacity divides *equally* among its
concurrent in-links (the assumption our paper criticizes via Fig. 2): the
tree is chosen to maximize the bottleneck under that assumption, but it is
*executed* under the simulator's real ingress model and bandwidth churn —
plan-once is exactly why PPT degrades in rapidly-changing networks
(paper Fig. 11/12).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.plan import Job, RepairPlan, Round, Transfer


@dataclasses.dataclass
class PPTTree:
    job: Job
    parent: dict[int, int]                 # helper/relay -> parent node
    children: dict[int, list[int]]

    @property
    def edges(self) -> list[tuple[int, int]]:
        return [(c, p) for c, p in self.parent.items()]

    def depths(self) -> dict[int, int]:
        """Hop distance of every tree node from the requestor root."""
        out: dict[int, int] = {}
        for node in self.parent:
            d, cur = 0, node
            while cur != self.job.requestor:
                cur = self.parent[cur]
                d += 1
            out[node] = d
        return out

    def assumed_bottleneck(self, bw: np.ndarray) -> float:
        bn = float("inf")
        for c, p in self.parent.items():
            fan_in = max(1, len(self.children.get(p, ())))
            bn = min(bn, bw[c, p] / fan_in)
        return bn


def ppt_round_plan(tree: PPTTree) -> RepairPlan:
    """Store-and-forward lowering of a pipeline tree to a `RepairPlan`.

    PPT executes as slice pipelining (no round structure), but the *bytes*
    it moves are well-defined: every tree node forwards the XOR-fold of
    its subtree's premultiplied terms to its parent. Lowering depth level
    d to round `dmax - d` (deepest first) yields an equivalent
    store-and-forward plan — by the time a node sends, all of its
    children's fragments have arrived and folded — so the byte data plane
    can execute and verify PPT repairs with the same machinery as the
    round schemes. Fan-in at interior nodes is real: validate with
    `max_recv_per_round` >= the tree's widest fan-in.
    """
    job = tree.job
    depths = tree.depths()
    dmax = max(depths.values(), default=0)
    terms: dict[int, set[int]] = {h: {h} for h in job.helpers}
    rounds = []
    for d in range(dmax, 0, -1):
        rnd = Round()
        for c in sorted(n for n, dd in depths.items() if dd == d):
            p = tree.parent[c]
            rnd.transfers.append(Transfer(
                src=c, dst=p, job=job.job_id, terms=frozenset(terms[c])))
            terms.setdefault(p, set()).update(terms[c])
            del terms[c]
        rounds.append(rnd)
    return RepairPlan(jobs=[job], rounds=rounds,
                      meta={"scheme": "ppt", "lowered_from": "pipeline-tree"})


def build_ppt_tree(job: Job, bw0: np.ndarray) -> PPTTree:
    """Greedy max-bottleneck attachment under PPT's equal-split assumption.

    PPT's model (quoted in the paper): "when multiple nodes send data to a
    node in parallel, the bandwidth of each link is the total bandwidth
    divided by the number of links" — i.e. the receiver's capacity (its
    best in-link) divides *equally* among concurrent in-links, regardless
    of each link's own rate. Under this belief fan-in looks cheap whenever
    helper-to-helper links are weak, so PPT happily builds multi-sender
    nodes — which the *real* ingress behaviour (Fig. 2: degraded total,
    skewed split) then punishes. That modeling gap is the paper's critique.

    This facade prices every (helper, attach-point) pair per greedy step
    as one `(H, V)` array expression (planner-layer idiom) instead of the
    historical nested-loop scan; the first-maximum argmax over the
    helper-major layout reproduces the scan's strict-`>` tie-breaking, so
    the tree built is identical.
    """
    root = job.requestor
    parent: dict[int, int] = {}
    children: dict[int, list[int]] = {root: []}
    attached = {root}
    remaining = list(job.helpers)
    capacity = bw0.max(axis=0)  # believed receiver capacity: best in-link

    def edge_rate(child: int, par: int, extra_child: bool) -> float:
        fan_in = len(children.get(par, ())) + (1 if extra_child else 0)
        if fan_in <= 1:
            return bw0[child, par]
        return capacity[par] / fan_in

    def bottleneck_to_root(node: int) -> float:
        bn = float("inf")
        cur = node
        while cur != root:
            p = parent[cur]
            bn = min(bn, edge_rate(cur, p, extra_child=False))
            cur = p
        return bn

    while remaining:
        att = list(attached)       # iteration order == historical scan order
        fan_in = np.array([len(children.get(v, ())) for v in att])
        # candidate edge h -> v priced with h as an extra child of v
        er = np.where(
            fan_in[None, :] == 0,
            bw0[np.ix_(remaining, att)],
            capacity[att][None, :] / np.maximum(fan_in[None, :] + 1, 1),
        )
        btr = np.array([
            bottleneck_to_root(v) if v != root else float("inf") for v in att
        ])
        rate = np.minimum(er, btr[None, :])
        hi, vi = np.unravel_index(int(rate.argmax()), rate.shape)
        h, v = remaining[hi], att[vi]
        parent[h] = v
        children.setdefault(v, []).append(h)
        children.setdefault(h, [])
        attached.add(h)
        remaining.remove(h)
    return PPTTree(job=job, parent=parent, children=children)
