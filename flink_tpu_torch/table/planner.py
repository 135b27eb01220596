"""Rule-driven logical planner for the SQL subset — a copy of
flink_tpu/table/planner.py (the reference's planner is JAX-free; only its
imports of the Table module point at the port's).

The reference plans SQL through Calcite: parse -> logical RelNode tree ->
rule-based rewriting -> physical DataSet/DataStream plan
(flink-libraries/flink-table/src/main/scala/org/apache/flink/api/table/
FlinkPlannerImpl.scala:46, plans/rules/). This module is that seam sized
to the in-repo SQL subset: a small logical-operator tree built from the
parsed query, a fixpoint pass pipeline of rewrite rules, and a lowering
step onto the existing columnar Table operators. Not a Calcite port —
the rules are the classical relational-algebra rewrites chosen for where
this engine actually spends time (join input width and probe size):

  * FilterPushdown     — WHERE conjuncts that reference exactly one side
                         of a join move below it (smaller probe input;
                         outer-join legality respected: left-side pushes
                         need how in {inner,left}, right-side pushes
                         how in {inner,right})
  * FilterMerge        — adjacent Filter nodes collapse into one
  * ConstantFilter     — literal-only conjuncts fold: TRUE drops out,
                         FALSE empties the subtree's scans (the classic
                         reduce-expressions rule)
  * ColumnPruning      — scans materialize only the columns the plan
                         above actually references (narrower join
                         gathers; the projection-pushdown rule)

EXPLAIN shows the unoptimized tree, the optimized tree, and the applied
rule trace, ahead of the measured physical plan (parity with the
reference's explain(): AST / Optimized Logical Plan / Physical Plan).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

# -- SQL fragment analysis ------------------------------------------------

_KEYWORDS = {
    "and", "or", "not", "like", "if", "true", "false", "null", "as",
    "between", "in", "is",
}


def stash_literals(sql: str):
    """Pull SQL string literals out before any keyword/identifier regex
    work (shared by refs/split_conjuncts/pushdown rename). Returns
    (stashed_sql, restore_fn)."""
    lits: List[str] = []

    def stash(m):
        lits.append(m.group(0))
        return f"\x00{len(lits) - 1}\x00"

    s = re.sub(r"'(?:[^']|'')*'", stash, sql)

    def restore(p: str) -> str:
        return re.sub(r"\x00(\d+)\x00",
                      lambda m: lits[int(m.group(1))], p)

    return s, restore


def refs(sql: str) -> Optional[Set[str]]:
    """Column identifiers a SQL fragment references. None = cannot be
    analyzed confidently (qualified refs survive only in ON clauses,
    which are handled separately) — callers must then be conservative."""
    s, _ = stash_literals(sql)
    if re.search(r"\b[A-Za-z_]\w*\s*\.\s*[A-Za-z_]\w*", s):
        return None                                   # qualified ref
    out = set()
    for m in re.finditer(r"\b([A-Za-z_]\w*)\b\s*(\()?", s):
        name, is_call = m.group(1), m.group(2)
        if is_call or name.lower() in _KEYWORDS:
            continue
        out.add(name)
    return out


def split_conjuncts(sql: str) -> List[str]:
    """Top-level AND split (parenthesized ORs stay whole; ANDs inside
    string literals don't split). A top-level un-parenthesized OR binds
    LOOSER than AND, so the expression is not a conjunction at all —
    return it whole rather than severing an OR operand."""
    s, restore = stash_literals(sql)
    # `X BETWEEN a AND b`: that AND is part of the operator, not a
    # conjunction — mask it before splitting, restore after
    s = re.sub(
        r"(\bBETWEEN\b\s+\S+\s+)\bAND\b", "\\1\x02", s,
        flags=re.IGNORECASE,
    )
    orig_restore = restore

    def restore(p: str) -> str:  # noqa: F811 — layered restore
        return orig_restore(p.replace("\x02", "AND"))

    depth = 0
    for tok in re.split(r"(\(|\))", s):
        if tok == "(":
            depth += 1
        elif tok == ")":
            depth -= 1
        elif depth == 0 and re.search(r"\bOR\b", tok, re.IGNORECASE):
            return [sql.strip()]
    parts, depth, cur = [], 0, []
    tokens = re.split(r"(\(|\)|\bAND\b)", s, flags=re.IGNORECASE)
    for tok in tokens:
        if tok == "(":
            depth += 1
        elif tok == ")":
            depth -= 1
        elif depth == 0 and re.fullmatch(r"AND", tok or "",
                                         re.IGNORECASE):
            parts.append("".join(cur).strip())
            cur = []
            continue
        cur.append(tok or "")
    if cur:
        parts.append("".join(cur).strip())
    return [restore(p) for p in parts if p]


# -- logical nodes --------------------------------------------------------

@dataclass
class LScan:
    name: str
    rows: int
    schema: List[str]
    keep: Optional[List[str]] = None    # ColumnPruning sets this
    empty: bool = False                 # ConstantFilter sets this

    def line(self) -> str:
        cols = f", cols={self.keep}" if self.keep is not None else ""
        emptied = ", emptied" if self.empty else ""
        return f"Scan({self.name}{cols}{emptied})"


@dataclass
class LFilter:
    input: "LNode"
    conjuncts: List[str]

    @property
    def schema(self):
        return self.input.schema

    def line(self) -> str:
        return f"Filter({' AND '.join(self.conjuncts)})"


@dataclass
class LJoin:
    left: "LNode"
    right: "LNode"
    how: str
    lks: List[str]
    rks: List[str]
    residual_sql: Optional[str]
    schema: List[str]
    clash: Set[str] = field(default_factory=set)

    def line(self) -> str:
        res = f", residual={self.residual_sql}" if self.residual_sql \
            else ""
        return (f"Join(how={self.how}, "
                f"keys={list(zip(self.lks, self.rks))}{res})")


@dataclass
class LProject:
    input: "LNode"
    items: List[str]
    schema: List[str]

    def line(self) -> str:
        return f"Project({self.items})"


@dataclass
class LAggregate:
    input: "LNode"
    keys: List[str]
    items: List[str]
    schema: List[str]

    def line(self) -> str:
        return f"Aggregate(keys={self.keys}, items={self.items})"


@dataclass
class LSort:
    input: "LNode"
    spec: str

    @property
    def schema(self):
        return self.input.schema

    def line(self) -> str:
        return f"Sort({self.spec})"


@dataclass
class LLimit:
    input: "LNode"
    n: int

    @property
    def schema(self):
        return self.input.schema

    def line(self) -> str:
        return f"Limit({self.n})"


LNode = object


def children(node) -> List[LNode]:
    if isinstance(node, LJoin):
        return [node.left, node.right]
    inp = getattr(node, "input", None)
    return [inp] if inp is not None else []


def render(node, indent: int = 0) -> str:
    pad = "  " * indent
    lines = [pad + node.line()]
    for c in children(node):
        lines.append(render(c, indent + 1))
    return "\n".join(lines)


# -- rewrite rules --------------------------------------------------------
# each rule: node -> (new_node, applied: bool); the optimizer recurses
# bottom-up and loops the pipeline to fixpoint.

def _join_side_of(name: str, join: LJoin) -> Optional[str]:
    """Which input of the join owns post-join column `name`; None =
    ambiguous or unknown."""
    lsch, rsch = set(join.left.schema), set(join.right.schema)
    if name.startswith("r_") and name[2:] in join.clash:
        return "right"
    if name in lsch and name not in rsch:
        return "left"
    if name in rsch and name not in lsch:
        return "right"
    if name in lsch and name in rsch:
        # shared merged key column: both sides hold it
        for lk, rk in zip(join.lks, join.rks):
            if lk == rk == name:
                return "both"
        return None    # clash column: bare name is the LEFT value
    return None


def rule_filter_pushdown(node):
    """WHERE conjuncts referencing exactly one join input move below it."""
    if not (isinstance(node, LFilter) and isinstance(node.input, LJoin)):
        return node, False
    join = node.input
    stay, to_left, to_right = [], [], []
    for cj in node.conjuncts:
        r = refs(cj)
        if r is None or not r:
            stay.append(cj)
            continue
        sides = {_join_side_of(n, join) for n in r}
        if sides == {"left"} or sides == {"left", "both"}:
            side = "left"
        elif sides <= {"right", "both"} and sides:
            side = "right"
        else:
            stay.append(cj)
            continue
        # outer-join legality: only the preserved side's predicates
        # commute with the null-extension
        if side == "left" and join.how in ("inner", "left"):
            to_left.append(cj)
        elif side == "right" and join.how in ("inner", "right"):
            # post-join names r_X -> right-side X; string literals are
            # stashed first so a value like 'r_credit' stays untouched
            s, restore = stash_literals(cj)
            s = re.sub(
                r"\br_([A-Za-z_]\w*)\b",
                lambda m: m.group(1) if m.group(1) in join.clash
                else m.group(0),
                s,
            )
            to_right.append(restore(s))
        else:
            stay.append(cj)
    if not to_left and not to_right:
        return node, False
    left = LFilter(join.left, to_left) if to_left else join.left
    right = LFilter(join.right, to_right) if to_right else join.right
    new_join = LJoin(left, right, join.how, join.lks, join.rks,
                     join.residual_sql, join.schema, join.clash)
    return (LFilter(new_join, stay) if stay else new_join), True


def rule_filter_merge(node):
    if isinstance(node, LFilter) and isinstance(node.input, LFilter):
        return LFilter(node.input.input,
                       node.conjuncts + node.input.conjuncts), True
    return node, False


def rule_having_pushdown(node):
    """HAVING conjuncts that reference only GROUP BY keys filter BEFORE
    the aggregation (the classic aggregate-pushdown: a key predicate
    selects whole groups, so applying it to the rows is equivalent and
    shrinks the hash-aggregate input)."""
    if not (isinstance(node, LFilter)
            and isinstance(node.input, LAggregate)):
        return node, False
    agg = node.input
    keys = set(agg.keys)
    # a SELECT alias that reuses a key's name SHADOWS it in the output:
    # `SUM(amount) AS region ... HAVING region > 3` filters the sum, so
    # pushing that conjunct to the raw key column would change results
    shadowed = set()
    for item in agg.items:
        m = re.match(r"^(.+?)\s+AS\s+(\w+)\s*$", item, re.IGNORECASE)
        if m and m.group(2) in keys and m.group(1).strip() != m.group(2):
            shadowed.add(m.group(2))
    pushable = keys - shadowed
    stay, push = [], []
    for cj in node.conjuncts:
        r = refs(cj)
        if r is not None and r and r <= pushable:
            push.append(cj)
        else:
            stay.append(cj)
    if not push:
        return node, False
    new_agg = LAggregate(LFilter(agg.input, push), agg.keys, agg.items,
                         agg.schema)
    return (LFilter(new_agg, stay) if stay else new_agg), True


def _empty_scans(node):
    if isinstance(node, LScan):
        return LScan(node.name, 0, node.schema, node.keep, empty=True)
    if isinstance(node, LJoin):
        return LJoin(_empty_scans(node.left), _empty_scans(node.right),
                     node.how, node.lks, node.rks, node.residual_sql,
                     node.schema, node.clash)
    out = type(node)(**{**node.__dict__, "input":
                        _empty_scans(node.input)})
    return out


def rule_constant_filter(node):
    """Literal-only conjuncts fold at plan time: TRUE drops, FALSE
    empties every scan under the filter (reduce-expressions)."""
    if not isinstance(node, LFilter):
        return node, False
    from flink_tpu_torch.table.table import _parse_expr

    keep, false = [], False
    changed = False
    for cj in node.conjuncts:
        r = refs(cj)
        if r:       # references columns (or None = unanalyzable)
            keep.append(cj)
            continue
        if r is None:
            keep.append(cj)
            continue
        import numpy as np

        val = bool(np.asarray(_parse_expr(cj).eval({}, 1)).reshape(-1)[0])
        changed = True
        if not val:
            false = True
    if not changed:
        return node, False
    if false:
        return _empty_scans(node.input), True
    return (LFilter(node.input, keep) if keep else node.input), True


def _required_for(node, required: Optional[Set[str]]):
    """Push the required-column set down one node; None = all columns.
    Project/Aggregate BOUND demand regardless of what sits above them —
    they only read their own items."""
    if isinstance(node, (LProject, LAggregate)):
        out = set(getattr(node, "keys", []) or [])
        for item in node.items:
            r = refs(item)
            if r is None:
                return None
            out |= r
        return out
    if required is None:
        return None
    if isinstance(node, LFilter):
        extra = set()
        for cj in node.conjuncts:
            r = refs(cj)
            if r is None:
                return None
            extra |= r
        return required | extra
    if isinstance(node, LSort):
        key = re.sub(r"\s+(DESC|ASC)$", "", node.spec.strip(),
                     flags=re.IGNORECASE).strip()
        return required | {key}
    return required


def _prune(node, required: Optional[Set[str]]):
    """Recursive column pruning; returns (node, applied)."""
    required = _required_for(node, required)
    if isinstance(node, LScan):
        if required is None:
            return node, False
        keep = [c for c in node.schema if c in required]
        if not keep:       # e.g. SELECT COUNT(*): any column carries n
            keep = node.schema[:1]
        if len(keep) < len(node.schema) and node.keep is None:
            return LScan(node.name, node.rows, node.schema, keep,
                         node.empty), True
        return node, False
    if isinstance(node, LJoin):
        if required is None:
            lreq = rreq = None
        else:
            lreq, rreq = set(node.lks), set(node.rks)
            res = refs(node.residual_sql) if node.residual_sql else set()
            if res is None:
                lreq = rreq = None
            else:
                for name in required | res:
                    side = _join_side_of(name, node)
                    if name.startswith("r_") and name[2:] in node.clash:
                        # r_X demands right's X AND left's X: pruning
                        # the left copy would un-clash the name and the
                        # join output would call right's column X, not
                        # r_X — keep both so naming stays stable
                        lreq.add(name[2:])
                        rreq.add(name[2:])
                        continue
                    if side in ("left", "both", None):
                        lreq.add(name)
                    if side in ("right", "both", None):
                        rreq.add(name)
        left, a1 = _prune(node.left, lreq)
        right, a2 = _prune(node.right, rreq)
        if a1 or a2:
            return LJoin(left, right, node.how, node.lks, node.rks,
                         node.residual_sql, node.schema,
                         node.clash), True
        return node, False
    kids = children(node)
    if not kids:
        return node, False
    child, applied = _prune(kids[0], required)
    if applied:
        return type(node)(**{**node.__dict__, "input": child}), True
    return node, False


def rule_column_pruning(root):
    """Top-level rule: prune scans to the columns the plan references.
    The root's own output demand seeds the traversal."""
    if isinstance(root, (LProject, LAggregate)):
        return _prune(root, set())
    return _prune(root, None)


def rule_limit_pushdown(node):
    """LIMIT under a NON-AGGREGATING projection: project only the
    surviving rows (projection is row-wise and order-preserving, so the
    same rows come out — just fewer expression evaluations). A
    projection carrying aggregates is a global aggregation (one output
    row from ALL inputs) and must see every row, so it is skipped; a
    Sort between them never arises (the grammar orders LIMIT above
    ORDER BY above the projection)."""
    if not (isinstance(node, LLimit) and isinstance(node.input, LProject)):
        return node, False
    from flink_tpu_torch.table.table import _AGGS

    proj = node.input
    for item in proj.items:
        s, _ = stash_literals(item)
        if re.search(r"\b(" + "|".join(_AGGS) + r")\s*\(", s,
                     re.IGNORECASE):
            return node, False
    return LProject(LLimit(proj.input, node.n), proj.items,
                    proj.schema), True


_LOCAL_RULES = [
    ("ConstantFilter", rule_constant_filter),
    ("FilterMerge", rule_filter_merge),
    ("HavingPushdown", rule_having_pushdown),
    ("FilterPushdown", rule_filter_pushdown),
    ("LimitPushdown", rule_limit_pushdown),
]


def _apply_local(node, applied: List[str]):
    """Bottom-up one pass of the per-node rules."""
    if isinstance(node, LJoin):
        node = LJoin(_apply_local(node.left, applied),
                     _apply_local(node.right, applied),
                     node.how, node.lks, node.rks, node.residual_sql,
                     node.schema, node.clash)
    elif children(node):
        node = type(node)(**{
            **node.__dict__,
            "input": _apply_local(node.input, applied),
        })
    for name, rule in _LOCAL_RULES:
        node, did = rule(node)
        if did:
            applied.append(name)
    return node


def optimize(root) -> Tuple[LNode, List[str]]:
    """Fixpoint over the local rules, then one column-pruning pass
    (pruning is a whole-plan property, so it runs once at the end)."""
    applied: List[str] = []
    for _ in range(10):
        before = len(applied)
        root = _apply_local(root, applied)
        if len(applied) == before:
            break
    root, did = rule_column_pruning(root)
    if did:
        applied.append("ColumnPruning")
    return root, applied
