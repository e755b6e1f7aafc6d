"""Plan-IR verifier: structural invariants of a `WorkloadDAG`.

The counterpart of `repro/analysis/ir_verifier.py`, copied.

The whole fused pipeline trusts the DAG blindly: the workload compiler
indexes children positionally, buckets batch nodes by spec, and — most
dangerously — the interner's canonical keys decide which subtrees SHARE
one buffer.  A silent key collision means two different subplans read
the same result and some query returns wrong answers with no error
anywhere.  This module re-derives every one of those structural facts
from first principles and reports divergences as findings:

  ir/cycle            child ids must strictly precede the node (DAG-ness)
  ir/child-bounds     child ids and spec column indexes must be in range
  ir/width            declared width == operator-derived output width
  ir/spec             operator spec well-formed for its kind
  ir/key-structure    `DagNode.key` consistent with (kind, spec, children)
  ir/key-collision    two distinct nodes share a canonical content key
  ir/key-instability  re-interning the representative plan changes keys
  ir/root-coverage    every expected member has a root; roots resolve
  ir/orphan           node unreachable from any root (dead weight)
  ir/consumers        consumer counts match actual edges
  ir/plan             representative plan tree malformed
"""
from __future__ import annotations

from repro_torch.analysis.findings import Finding
from repro_torch.query.dag import WorkloadDAG, derived_width
from repro_torch.query.plan import TTScan, ViewRef, validate_plan

_KINDS = ("scan", "view", "filter", "join", "project")


def _f(rule: str, severity: str, message: str, location: str = "") -> Finding:
    return Finding("ir", rule, severity, message, location)


def verify_dag(dag: WorkloadDAG,
               expected_members: set[str] | None = None) -> list[Finding]:
    """Statically verify a workload DAG; returns findings (empty = sound)."""
    out: list[Finding] = []
    n = len(dag.nodes)

    # ---- per-node structure ------------------------------------------
    for node in dag.nodes:
        loc = f"node {node.id} ({node.kind})"
        if node.kind not in _KINDS:
            out.append(_f("ir/spec", "error",
                          f"unknown operator kind {node.kind!r}", loc))
            continue
        if node.id >= n or dag.nodes[node.id] is not node:
            out.append(_f("ir/child-bounds", "error",
                          "node id does not match its position", loc))
            continue
        # acyclicity: the interner numbers children before parents, and
        # every downstream pass (waves, execution order, content keys)
        # relies on exactly that
        bad_child = False
        for c in node.child_ids:
            if not (0 <= c < n):
                out.append(_f("ir/child-bounds", "error",
                              f"child id {c} out of range [0, {n})", loc))
                bad_child = True
            elif c >= node.id:
                out.append(_f("ir/cycle", "error",
                              f"child id {c} does not precede the node — "
                              "topological order (and acyclicity) broken",
                              loc))
                bad_child = True
        if bad_child:
            continue
        out.extend(_verify_spec(dag, node, loc))
        out.extend(_verify_width(dag, node, loc))
        out.extend(_verify_key_structure(node, loc))
        if node.plan is not None:
            problems = validate_plan(node.plan)
            out.extend(_f("ir/plan", "error", p, loc) for p in problems)

    # ---- consumer-count consistency ----------------------------------
    true_consumers = {nid: 0 for nid in range(n)}
    for node in dag.nodes:
        for c in node.child_ids:
            if 0 <= c < n:
                true_consumers[c] += 1
    for nid in dag.roots.values():
        if 0 <= nid < n:
            true_consumers[nid] += 1
    for nid, expected in true_consumers.items():
        got = dag.consumers.get(nid, 0)
        if got != expected:
            out.append(_f(
                "ir/consumers", "error",
                f"consumer count {got} != actual edge count {expected} "
                "(sharing telemetry and reuse accounting are wrong)",
                f"node {nid}"))

    # ---- root coverage + reachability --------------------------------
    reachable: set[int] = set()
    for name, rid in dag.roots.items():
        if not (0 <= rid < n):
            out.append(_f("ir/root-coverage", "error",
                          f"root id {rid} out of range", f"root {name!r}"))
            continue
        stack = [rid]
        while stack:
            cur = stack.pop()
            if cur in reachable:
                continue
            reachable.add(cur)
            stack.extend(c for c in dag.nodes[cur].child_ids
                         if 0 <= c < n)
    if expected_members is not None:
        missing = expected_members - set(dag.roots)
        for name in sorted(missing):
            out.append(_f(
                "ir/root-coverage", "error",
                "workload member has no root in the DAG — its query is "
                "silently unanswered", f"root {name!r}"))
    for nid in range(n):
        if nid not in reachable:
            out.append(_f("ir/orphan", "warning",
                          "node unreachable from any root (computed every "
                          "execute, read by nobody)", f"node {nid}"))

    # ---- canonical-key soundness -------------------------------------
    out.extend(_verify_keys(dag))
    return out


def _verify_spec(dag: WorkloadDAG, node, loc: str) -> list[Finding]:
    out: list[Finding] = []
    widths = [dag.nodes[c].width for c in node.child_ids]
    if node.kind == "scan":
        if node.child_ids:
            out.append(_f("ir/spec", "error", "scan must be a leaf", loc))
    elif node.kind == "view":
        if node.child_ids:
            out.append(_f("ir/spec", "error", "view must be a leaf", loc))
        if not isinstance(node.spec, int):
            out.append(_f("ir/spec", "error",
                          f"view spec must be a view id, got "
                          f"{type(node.spec).__name__}", loc))
    elif node.kind == "filter":
        if len(node.child_ids) != 1:
            out.append(_f("ir/spec", "error",
                          f"filter needs 1 child, has {len(node.child_ids)}",
                          loc))
        else:
            ci, _value = node.spec
            if not (0 <= ci < widths[0]):
                out.append(_f("ir/child-bounds", "error",
                              f"filter column {ci} out of child width "
                              f"{widths[0]}", loc))
    elif node.kind == "join":
        if len(node.child_ids) != 2:
            out.append(_f("ir/spec", "error",
                          f"join needs 2 children, has {len(node.child_ids)}",
                          loc))
        else:
            if not node.spec:
                out.append(_f("ir/spec", "error",
                              "join with no equality pairs (cartesian "
                              "products never reach the device DAG)", loc))
            for l, r in node.spec:
                if not (0 <= l < widths[0]):
                    out.append(_f("ir/child-bounds", "error",
                                  f"join left column {l} out of width "
                                  f"{widths[0]}", loc))
                if not (0 <= r < widths[1]):
                    out.append(_f("ir/child-bounds", "error",
                                  f"join right column {r} out of width "
                                  f"{widths[1]}", loc))
    elif node.kind == "project":
        if len(node.child_ids) != 1:
            out.append(_f("ir/spec", "error",
                          f"project needs 1 child, has "
                          f"{len(node.child_ids)}", loc))
        else:
            idxs, dedupe = node.spec
            if not isinstance(dedupe, bool):
                out.append(_f("ir/spec", "error",
                              "project dedupe flag must be bool", loc))
            for i in idxs:
                if not (0 <= i < widths[0]):
                    out.append(_f("ir/child-bounds", "error",
                                  f"project column {i} out of child width "
                                  f"{widths[0]}", loc))
    return out


def _verify_width(dag: WorkloadDAG, node, loc: str) -> list[Finding]:
    if node.kind == "view":
        # not derivable from the spec; check against the representative
        if isinstance(node.plan, ViewRef) and \
                len(node.plan.schema) != node.width:
            return [_f("ir/width", "error",
                       f"declared width {node.width} != representative "
                       f"schema arity {len(node.plan.schema)}", loc)]
        return []
    try:
        want = derived_width(
            node.kind, node.spec,
            tuple(dag.nodes[c].width for c in node.child_ids))
    except (TypeError, IndexError, ValueError) as e:
        return [_f("ir/spec", "error",
                   f"width underivable from spec: {e}", loc)]
    if want != node.width:
        return [_f("ir/width", "error",
                   f"declared width {node.width} != operator-derived width "
                   f"{want} — consumers index a misaligned buffer", loc)]
    return []


def _verify_key_structure(node, loc: str) -> list[Finding]:
    """`DagNode.key` must encode exactly (kind, spec, child ids): a key
    that drifted from the node's actual structure is how two different
    subplans end up interned together."""
    key = node.key
    if not isinstance(key, tuple) or not key or key[0] != node.kind:
        return [_f("ir/key-structure", "error",
                   f"key {key!r} does not lead with the node kind", loc)]
    ok = True
    if node.kind == "filter":
        ci, value = node.spec
        ok = key[1:] == (node.child_ids[0], ci, value)
    elif node.kind == "join":
        ok = (len(key) == 4 and key[1] == node.child_ids[0]
              and key[2] == node.child_ids[1]
              and key[3] == tuple(sorted(node.spec)))
    elif node.kind == "project":
        idxs, dedupe = node.spec
        ok = key[1:] == (node.child_ids[0], idxs, dedupe)
    elif node.kind == "view":
        ok = key[1:] == (node.spec,)
    # scan keys hold the renaming-invariant atom encoding; checked via
    # re-interning in _verify_keys
    if not ok:
        return [_f("ir/key-structure", "error",
                   f"key {key!r} inconsistent with spec {node.spec!r} / "
                   f"children {node.child_ids}", loc)]
    return []


def _verify_keys(dag: WorkloadDAG) -> list[Finding]:
    """Canonical-key soundness: recompute keys from the representative
    plans and detect collisions/instabilities.

    * collision — two distinct live nodes with equal fully-recursive
      content keys should have been ONE node; if their plans differ
      semantically the shared buffer returns wrong answers for one of
      them.
    * instability — re-interning every root's representative plan into
      a fresh DAG must reproduce each root's content key; divergence
      means interning depends on construction order, so swap/retune
      rebuilds silently re-wire consumers.
    """
    out: list[Finding] = []
    try:
        keys = dag.content_keys()
    except (TypeError, IndexError) as e:
        return [_f("ir/key-structure", "error",
                   f"content keys uncomputable: {e}")]
    seen: dict = {}
    for nid, key in enumerate(keys):
        if key in seen:
            out.append(_f(
                "ir/key-collision", "error",
                f"nodes {seen[key]} and {nid} share canonical content key "
                "— the interner should have merged them; two subplans are "
                "aliasing one buffer", f"node {nid}"))
        else:
            seen[key] = nid

    if any(node.plan is None for node in dag.nodes):
        return out  # synthetic DAG without representatives
    fresh = WorkloadDAG()
    try:
        for name in sorted(dag.roots):
            fresh.add_root(name, dag.nodes[dag.roots[name]].plan)
        fresh_keys = fresh.content_keys()
    except Exception as e:  # interning itself blew up on a corrupt plan
        return out + [_f("ir/key-instability", "error",
                         f"re-interning representative plans failed: {e}")]
    for name in sorted(dag.roots):
        old = keys[dag.roots[name]]
        new = fresh_keys[fresh.roots[name]]
        if old != new:
            out.append(_f(
                "ir/key-instability", "error",
                "re-interning the representative plan yields a different "
                "canonical key — interning is order-dependent",
                f"root {name!r}"))
    return out
