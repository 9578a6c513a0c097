"""Typed compression specs and per-layer policies (the port's copy of
``repro/core/specs.py``; specs and policies serialize to the same JSON, so
checkpoint manifests read the same in both packages):

* :class:`PruneSpec` / :class:`QuantSpec` / :class:`JointSpec` — what to do
  to one weight (method name + its hyper-parameters);
* :class:`Policy` — which spec applies to which layer, by fnmatch pattern
  over the layer's qualified name (``blocks.3.attn.wq``), first match wins,
  with an optional default. A rule mapping to ``None`` skips the layer
  (stays dense).

Specs are frozen dataclasses (hashable, JSON-serializable).
"""
from __future__ import annotations

import dataclasses
import fnmatch
import math
from typing import Dict, Iterable, List, Optional, Tuple, Union


def effective_group(d_in: int, group_size: int) -> int:
    """Largest divisor of ``d_in`` that is ≤ ``group_size``.

    Direct divisor enumeration in O(√d_in) (the old linear descent was
    O(d_in) for prime fan-ins). Production dims are multiples of 128, but
    tiny/test models have odd and even-prime d_in.
    """
    g = min(group_size, d_in)
    if g <= 1 or d_in % g == 0:
        return max(g, 1)
    best = 1
    for i in range(1, math.isqrt(d_in) + 1):
        if d_in % i:
            continue
        if i <= g and i > best:
            best = i
        j = d_in // i
        if j <= g and j > best:
            best = j
    return best


@dataclasses.dataclass(frozen=True)
class CompressSpec:
    """Base spec: a registered method name plus shared knobs."""
    method: str = ""
    damp: float = 0.01           # covariance damping (MoE low-token guard)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["kind"] = type(self).__name__
        return d


@dataclasses.dataclass(frozen=True)
class PruneSpec(CompressSpec):
    """Sparsify: ``ratio`` = fraction zeroed; ``nm`` = N:M structured."""
    method: str = "awp_prune"
    ratio: float = 0.5
    nm: Optional[Tuple[int, int]] = None

    def k_for(self, d_in: int) -> int:
        """Kept entries per row, k = (1-ratio)·d_in (≥ 1)."""
        return max(1, int(round((1.0 - self.ratio) * d_in)))


@dataclasses.dataclass(frozen=True)
class QuantSpec(CompressSpec):
    """Quantize to INT-``bits`` with per-(row, group) affine params."""
    method: str = "awp_quant"
    bits: int = 4
    group_size: int = 128

    def group_for(self, d_in: int) -> int:
        return effective_group(d_in, self.group_size)


@dataclasses.dataclass(frozen=True)
class JointSpec(CompressSpec):
    """Prune AND quantize (native joint recipe or sequential pipelines)."""
    method: str = "awp_joint"
    ratio: float = 0.5
    nm: Optional[Tuple[int, int]] = None
    bits: int = 4
    group_size: int = 128

    k_for = PruneSpec.k_for
    group_for = QuantSpec.group_for


_SPEC_KINDS = {c.__name__: c for c in
               (CompressSpec, PruneSpec, QuantSpec, JointSpec)}


def spec_from_dict(d: dict) -> CompressSpec:
    d = dict(d)
    cls = _SPEC_KINDS[d.pop("kind", "CompressSpec")]
    if d.get("nm") is not None:
        d["nm"] = tuple(d["nm"])
    return cls(**d)


# ---------------------------------------------------------------------------
# Policy: layer-name patterns → specs
# ---------------------------------------------------------------------------

RuleValue = Optional[CompressSpec]
RulesLike = Union[Dict[str, RuleValue], Iterable[Tuple[str, RuleValue]]]


@dataclasses.dataclass(frozen=True)
class Rule:
    pattern: str                 # fnmatch pattern over the qualified name
    spec: RuleValue              # None = leave this layer dense
    alias_only: bool = False     # match ONLY the short-name aliases (legacy
                                 # substring-skip semantics: "*o*" must not
                                 # hit the "o" in "blocks.0...")


class Policy:
    """Ordered pattern → spec map with first-match precedence.

    >>> Policy({"blocks.0.*": None,            # skip block 0
    ...         "*.attn.*": QuantSpec(bits=8),
    ...         "*.mlp.*": QuantSpec(bits=4)},
    ...        default=PruneSpec(ratio=0.5))

    ``spec_for(name, *aliases)`` returns the spec of the first rule whose
    pattern matches the qualified name (or any alias, e.g. the short
    per-block name), falling back to ``default``. ``None`` means "leave
    dense".
    """

    def __init__(self, rules: RulesLike = (), *,
                 default: RuleValue = None):
        if isinstance(rules, dict):
            rules = rules.items()
        self.rules: List[Rule] = [r if isinstance(r, Rule) else Rule(*r)
                                  for r in rules]
        self.default = default

    def spec_for(self, name: str, *aliases: str) -> RuleValue:
        for rule in self.rules:
            names = aliases if rule.alias_only else (name,) + aliases
            if any(fnmatch.fnmatchcase(n, rule.pattern) for n in names):
                return rule.spec
        return self.default

    def methods(self) -> Tuple[str, ...]:
        """Distinct method names this policy can dispatch to."""
        specs = [r.spec for r in self.rules] + [self.default]
        return tuple(dict.fromkeys(s.method for s in specs if s is not None))

    def to_dict(self) -> dict:
        return {"rules": [[r.pattern,
                           None if r.spec is None else r.spec.to_dict()]
                          + ([True] if r.alias_only else [])
                          for r in self.rules],
                "default": (None if self.default is None
                            else self.default.to_dict())}

    @staticmethod
    def from_dict(d: dict) -> "Policy":
        rules = [Rule(r[0], None if r[1] is None else spec_from_dict(r[1]),
                      *r[2:])
                 for r in d.get("rules", ())]
        default = d.get("default")
        return Policy(rules, default=None if default is None
                      else spec_from_dict(default))

    def __repr__(self):
        rs = ", ".join(f"{r.pattern!r}→{getattr(r.spec, 'method', None)}"
                       for r in self.rules)
        return (f"Policy([{rs}], default="
                f"{getattr(self.default, 'method', None)})")


def qualified_name(path, layer: Optional[int]) -> str:
    """Dotted layer name for policy matching: ("blocks","attn","wq") at
    block 3 → "blocks.3.attn.wq"; expert paths keep their trailing index
    ("blocks","moe","wu",7) → "blocks.2.moe.wu.7"."""
    parts = [str(p) for p in path]
    if parts and parts[0] == "blocks" and layer is not None:
        parts.insert(1, str(layer))
    return ".".join(parts)


__all__ = ["CompressSpec", "PruneSpec", "QuantSpec", "JointSpec", "Policy",
           "Rule", "effective_group", "qualified_name", "spec_from_dict"]
