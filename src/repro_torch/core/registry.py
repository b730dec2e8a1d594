"""Offline package registry + dependency resolver (the port's own copy of
``repro.core.registry``, which imports no framework).

This models §II-A of the paper: a secure HPC system has *no internet
access*, so ``pip install`` on the cluster cannot work, and a single shared
Python instance breaks under multi-framework use because transitive
dependency up/downgrades clobber previously installed frameworks (the
paper's TensorFlow-then-Caffe example).

The registry is a local, versioned index.  ``Resolver`` performs constraint
resolution at *image build time* — the Charliecloud answer: every
environment is resolved against the offline index into an immutable,
per-image package set, so two frameworks with conflicting pins live in two
images instead of fighting over one site-packages.

``SharedEnvironment`` deliberately reproduces the breakage: sequential
installs mutate one shared package set, and the conflict test in
``tests/test_registry.py`` shows framework A's pins violated after
installing framework B — then shows two ``EnvironmentCapsule`` images
resolving cleanly.
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


class ResolutionError(RuntimeError):
    pass


class OfflineViolation(RuntimeError):
    """Raised when something tries to reach the network on the cluster."""


# ---------------------------------------------------------------------------
# Versions & constraints (PEP-440-lite: major.minor.patch, ==, >=, <=, <, >, !=)
# ---------------------------------------------------------------------------

def parse_version(v: str) -> Tuple[int, ...]:
    parts = v.split(".")
    if not all(p.isdigit() for p in parts):
        raise ValueError(f"bad version {v!r}")
    return tuple(int(p) for p in parts) + (0,) * (3 - len(parts))


_CONSTRAINT_RE = re.compile(r"^(==|>=|<=|!=|<|>)?\s*([\d.]+)$")


@dataclass(frozen=True)
class Constraint:
    op: str
    version: Tuple[int, ...]

    @classmethod
    def parse(cls, s: str) -> "Constraint":
        m = _CONSTRAINT_RE.match(s.strip())
        if not m:
            raise ValueError(f"bad constraint {s!r}")
        return cls(m.group(1) or "==", parse_version(m.group(2)))

    def satisfied_by(self, v: Tuple[int, ...]) -> bool:
        return {"==": v == self.version, "!=": v != self.version,
                ">=": v >= self.version, "<=": v <= self.version,
                ">": v > self.version, "<": v < self.version}[self.op]

    def __str__(self) -> str:
        return f"{self.op}{'.'.join(map(str, self.version))}"


@dataclass(frozen=True)
class Requirement:
    name: str
    constraints: Tuple[Constraint, ...] = ()

    @classmethod
    def parse(cls, s: str) -> "Requirement":
        m = re.match(r"^([A-Za-z0-9_.-]+)\s*(.*)$", s.strip())
        name, rest = m.group(1), m.group(2)
        cons = tuple(Constraint.parse(c) for c in rest.split(",") if c.strip())
        return cls(name.lower(), cons)

    def satisfied_by(self, v: Tuple[int, ...]) -> bool:
        return all(c.satisfied_by(v) for c in self.constraints)

    def __str__(self) -> str:
        return self.name + ",".join(map(str, self.constraints))


@dataclass(frozen=True)
class PackageSpec:
    name: str
    version: str
    requires: Tuple[str, ...] = ()          # requirement strings

    @property
    def vtuple(self) -> Tuple[int, ...]:
        return parse_version(self.version)

    @property
    def requirements(self) -> Tuple[Requirement, ...]:
        return tuple(Requirement.parse(r) for r in self.requires)


# ---------------------------------------------------------------------------
# The offline index
# ---------------------------------------------------------------------------

class PackageIndex:
    """A local (air-gap-safe) package index."""

    def __init__(self, offline: bool = True):
        self._pkgs: Dict[str, Dict[str, PackageSpec]] = {}
        self.offline = offline

    def publish(self, spec: PackageSpec) -> None:
        self._pkgs.setdefault(spec.name.lower(), {})[spec.version] = spec

    def versions(self, name: str) -> List[PackageSpec]:
        out = sorted(self._pkgs.get(name.lower(), {}).values(),
                     key=lambda s: s.vtuple, reverse=True)
        return out

    def fetch_remote(self, name: str) -> PackageSpec:
        raise OfflineViolation(
            f"attempted network fetch of {name!r}: the cluster has no internet "
            "access (paper §III-A); resolve at image build time instead")


def default_index() -> PackageIndex:
    """An index stocked with the paper's cast of characters.

    The tensorflow/caffe pins reproduce the paper's §II-A conflict:
    tensorflow 1.11 needs protobuf>=3.6, caffe 1.0 pins protobuf==2.6.1.
    Every entry of the reference's index is here, number for number, but
    its own package: in its place stand the packages of a PyTorch image,
    ``torch`` and this port (``repro-torch``).  A simulated offline index,
    held as data: nothing is downloaded.
    """
    idx = PackageIndex()
    for spec in [
        PackageSpec("numpy", "1.15.4"),
        PackageSpec("numpy", "1.14.5"),
        PackageSpec("protobuf", "3.6.1"),
        PackageSpec("protobuf", "3.6.0"),
        PackageSpec("protobuf", "2.6.1"),
        PackageSpec("six", "1.11.0"),
        PackageSpec("tensorflow", "1.11.0",
                    ("numpy>=1.14.5", "protobuf>=3.6.0", "six>=1.10.0")),
        PackageSpec("caffe", "1.0.0", ("numpy>=1.14.0", "protobuf==2.6.1")),
        PackageSpec("keras", "2.2.4", ("numpy>=1.14.5", "six>=1.9.0")),
        PackageSpec("horovod", "0.15.2", ("tensorflow>=1.10.0", "six>=1.10.0")),
        PackageSpec("intel-tensorflow", "1.11.0",
                    ("numpy>=1.14.5", "protobuf>=3.6.0", "six>=1.10.0")),
        PackageSpec("mpi4py", "3.0.0"),
        PackageSpec("torch", "2.11.0", ("numpy>=1.14.5",)),
        PackageSpec("repro-torch", "0.1.0", ("torch>=2.0.0",
                                              "numpy>=1.14.5")),
    ]:
        idx.publish(spec)
    return idx


# ---------------------------------------------------------------------------
# Resolver (build-time, per-image)
# ---------------------------------------------------------------------------

class Resolver:
    """Backtracking version resolver over the offline index."""

    def __init__(self, index: PackageIndex):
        self.index = index

    def resolve(self, requirements: Sequence[str]) -> Dict[str, PackageSpec]:
        reqs = [Requirement.parse(r) for r in requirements]
        solution = self._solve({}, list(reqs))
        if solution is None:
            raise ResolutionError(
                f"no consistent package set satisfies {list(map(str, reqs))}")
        return solution

    def _solve(self, pinned: Dict[str, PackageSpec],
               todo: List[Requirement]) -> Optional[Dict[str, PackageSpec]]:
        if not todo:
            return dict(pinned)
        req, rest = todo[0], todo[1:]
        if req.name in pinned:
            if req.satisfied_by(pinned[req.name].vtuple):
                return self._solve(pinned, rest)
            return None                                   # conflict: backtrack
        candidates = [s for s in self.index.versions(req.name)
                      if req.satisfied_by(s.vtuple)]
        if not candidates and not self.index._pkgs.get(req.name):
            # the paper's failure mode: pip would now hit the network
            self.index.fetch_remote(req.name)
        for cand in candidates:
            pinned[req.name] = cand
            sol = self._solve(pinned, rest + list(cand.requirements))
            if sol is not None:
                return sol
            del pinned[req.name]
        return None


# ---------------------------------------------------------------------------
# The shared-environment failure mode (§II-A) — kept as an executable model
# ---------------------------------------------------------------------------

class SharedEnvironment:
    """A single shared Python instance: sequential ``pip install`` semantics.

    Installing framework B silently up/downgrades shared dependencies that
    framework A pinned — ``check()`` then reports A as broken.  This is the
    behavior the paper cites as the reason a shared Python cannot serve
    multi-user HPC, and the motivation for per-image resolution.
    """

    def __init__(self, index: PackageIndex):
        self.index = index
        self.installed: Dict[str, PackageSpec] = {}
        self.roots: List[str] = []

    def pip_install(self, requirement: str) -> None:
        req = Requirement.parse(requirement)
        resolver = Resolver(self.index)
        # pip-style: resolve the new root in isolation, then overwrite shared
        # packages with whatever the new resolution picked.
        sol = resolver.resolve([requirement])
        self.installed.update(sol)
        self.roots.append(requirement)

    def check(self) -> Dict[str, List[str]]:
        """Return {root: [violations]} across everything installed."""
        problems: Dict[str, List[str]] = {}
        for root in self.roots:
            name = Requirement.parse(root).name
            spec = self.installed.get(name)
            stack = list(spec.requirements) if spec else []
            seen = set()
            while stack:
                r = stack.pop()
                if r.name in seen:
                    continue
                seen.add(r.name)
                dep = self.installed.get(r.name)
                if dep is None:
                    problems.setdefault(root, []).append(f"missing {r.name}")
                elif not r.satisfied_by(dep.vtuple):
                    problems.setdefault(root, []).append(
                        f"{r} violated by installed {dep.name}=={dep.version}")
                else:
                    stack.extend(dep.requirements)
        return problems
