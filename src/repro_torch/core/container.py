"""Charliecloud-style environment capsules (UDSS) — the paper's §II-F/§III-B
(the port's own copy of ``repro.core.container``, which imports no
framework; the capsule format is the reference's, so an image built by
either package unpacks and runs under the other's runtime).

The workflow contract implemented here is exactly the paper's:

  workstation (has internet, has root):
      ch-build            -> ImageBuilder.build()      (resolve deps, §II-A)
      ch-docker2tar       -> Image.flatten()           (single archive file)
      scp                 -> transfer()                (onto the cluster)
  cluster (no internet, no root, Slurm only):
      ch-tar2dir          -> unpack()                  (into node-local tmpfs)
      ch-run              -> CapsuleRuntime.run()      (unprivileged launch)

Python cannot create kernel user namespaces, so the *isolation mechanism*
is simulated — but the *policy* is real and enforced: images are immutable
(content-hash verified before and after every run), the runtime scrubs the
environment and blocks network access flags, building requires the
"workstation" context (network+root) while running requires neither, and
attempts to install packages inside a running capsule raise
``OfflineViolation`` just like ``pip install`` dies on the real SuperMUC-NG.
The security review table of the paper (Docker: root escalation; Singularity:
banned at LRZ after privilege escalation) is encoded in ``SecurityPolicy``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import inspect
import io
import json
import os
import shutil
import tarfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core.registry import (OfflineViolation, PackageIndex,
                                       PackageSpec, Resolver)


class SecurityError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# Security policy (the paper's §II-C..F comparison, encoded)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RuntimeProfile:
    name: str
    requires_root_daemon: bool
    requires_setuid: bool
    uses_cgroups: bool                 # conflicts with Slurm's cgroup usage
    unprivileged_user_namespace: bool
    known_escalations: bool


RUNTIME_PROFILES = {
    "docker": RuntimeProfile("docker", True, False, True, False, True),
    "singularity": RuntimeProfile("singularity", False, True, False, True, True),
    "shifter": RuntimeProfile("shifter", False, False, False, False, False),
    "charliecloud": RuntimeProfile("charliecloud", False, False, False, True, False),
}


@dataclass(frozen=True)
class SecurityPolicy:
    """LRZ-style site policy for a secure HPC system."""
    allow_internet: bool = False
    allow_root: bool = False
    allow_setuid: bool = False
    allow_cgroup_runtimes: bool = False     # Slurm owns cgroups
    allow_known_escalations: bool = False   # the Singularity incident

    def admit(self, profile: RuntimeProfile) -> None:
        if profile.requires_root_daemon and not self.allow_root:
            raise SecurityError(
                f"{profile.name}: requires a root daemon (paper §II-C)")
        if profile.requires_setuid and not self.allow_setuid:
            raise SecurityError(
                f"{profile.name}: setuid binary not allowed on this site")
        if profile.uses_cgroups and not self.allow_cgroup_runtimes:
            raise SecurityError(
                f"{profile.name}: cgroup isolation conflicts with Slurm")
        if profile.known_escalations and not self.allow_known_escalations:
            raise SecurityError(
                f"{profile.name}: banned after privilege-escalation incident "
                "(paper §II-D)")
        if not profile.unprivileged_user_namespace:
            raise SecurityError(
                f"{profile.name}: needs admin setup; site requires "
                "user-namespace-only launch (paper §II-E/F)")


# ---------------------------------------------------------------------------
# Execution contexts
# ---------------------------------------------------------------------------

@dataclass
class HostContext:
    """Where a command runs: the connected workstation or the secure cluster."""
    name: str
    has_internet: bool
    has_root: bool

    def require_internet(self, what: str) -> None:
        if not self.has_internet:
            raise OfflineViolation(
                f"{what} needs internet but {self.name} is air-gapped")


WORKSTATION = HostContext("workstation", has_internet=True, has_root=True)
CLUSTER = HostContext("supermuc-ng", has_internet=False, has_root=False)


# ---------------------------------------------------------------------------
# Image definition & build
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ImageDefinition:
    """The Dockerfile analogue."""
    name: str
    base: str = "ubuntu:18.04"
    requirements: Sequence[str] = ()         # resolved at build time
    env: Dict[str, str] = field(default_factory=dict)
    entrypoint: str = "python"
    labels: Dict[str, str] = field(default_factory=dict)


@dataclass(frozen=True)
class Image:
    """A built, immutable image: resolved package set + content hash."""
    definition: ImageDefinition
    packages: Dict[str, str]                 # name -> version (fully resolved)
    content_hash: str
    built_at: float

    def manifest(self) -> Dict[str, Any]:
        return {
            "name": self.definition.name,
            "base": self.definition.base,
            "packages": dict(sorted(self.packages.items())),
            "env": dict(self.definition.env),
            "entrypoint": self.definition.entrypoint,
            "labels": dict(self.definition.labels),
            "content_hash": self.content_hash,
        }


class ImageBuilder:
    """``ch-build``: runs on the workstation, resolves deps against the index."""

    def __init__(self, index: PackageIndex, context: HostContext = WORKSTATION):
        self.index = index
        self.context = context

    def build(self, definition: ImageDefinition) -> Image:
        # dependency resolution may need the index network mirror — the
        # whole point is that this happens HERE, not on the cluster.
        self.context.require_internet(f"building image {definition.name!r}")
        solution = Resolver(self.index).resolve(list(definition.requirements))
        packages = {s.name: s.version for s in solution.values()}
        blob = json.dumps({"def": dataclasses.asdict(definition),
                           "pkgs": sorted(packages.items())},
                          sort_keys=True, default=list).encode()
        return Image(definition, packages,
                     hashlib.sha256(blob).hexdigest(), time.time())


# ---------------------------------------------------------------------------
# Flatten / transfer / unpack (ch-docker2tar, scp, ch-tar2dir)
# ---------------------------------------------------------------------------

def flatten(image: Image, out_dir: Path) -> Path:
    """``ch-docker2tar``: one archive file, the unit of distribution."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{image.definition.name}.tar.gz"
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        data = json.dumps(image.manifest(), indent=2).encode()
        info = tarfile.TarInfo("image/manifest.json")
        info.size = len(data)
        tar.addfile(info, io.BytesIO(data))
        for pkg, ver in sorted(image.packages.items()):
            pdata = f"# site-packages stand-in for {pkg}=={ver}\n".encode()
            pinfo = tarfile.TarInfo(f"image/site-packages/{pkg}-{ver}/__init__.py")
            pinfo.size = len(pdata)
            tar.addfile(pinfo, io.BytesIO(pdata))
    path.write_bytes(buf.getvalue())
    return path


def transfer(archive: Path, cluster_dir: Path) -> Path:
    """``scp`` to the cluster: the only thing that crosses the air gap."""
    cluster_dir = Path(cluster_dir)
    cluster_dir.mkdir(parents=True, exist_ok=True)
    dest = cluster_dir / Path(archive).name
    shutil.copy2(archive, dest)
    return dest


def unpack(archive: Path, dest_root: Path,
           context: HostContext = CLUSTER) -> Path:
    """``ch-tar2dir``: unpack into node-local storage (tmpfs stand-in).

    Refuses to clobber an existing unpacked image of a different build —
    the paper's warning about ch-tar2dir overwriting same-named dirs.
    """
    dest_root = Path(dest_root)
    name = Path(archive).name.replace(".tar.gz", "")
    dest = dest_root / name
    with tarfile.open(archive, "r:gz") as tar:
        manifest = json.loads(tar.extractfile("image/manifest.json").read())
        if dest.exists():
            # a crashed prior ch-tar2dir leaves a partial tree: a missing
            # or unparseable manifest is indistinguishable from a foreign
            # image, so it gets the same refusal instead of a raw
            # FileNotFoundError / JSONDecodeError
            try:
                old = json.loads((dest / "image/manifest.json").read_text())
                old_hash = old["content_hash"]
            except (OSError, ValueError, KeyError):
                old_hash = None
            if old_hash != manifest["content_hash"]:
                raise SecurityError(
                    f"{dest} holds a different or partially unpacked image "
                    "(hash mismatch); refusing to overwrite — remove it "
                    "explicitly first")
            shutil.rmtree(dest)
        dest.mkdir(parents=True)
        tar.extractall(dest, filter="data")
    return dest


def _tree_hash(root: Path) -> str:
    h = hashlib.sha256()
    for p in sorted(Path(root).rglob("*")):
        if p.is_file():
            h.update(p.relative_to(root).as_posix().encode())
            h.update(p.read_bytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# ch-run: the unprivileged runtime
# ---------------------------------------------------------------------------

# env vars that leak host identity / enable network — scrubbed on entry
_SCRUBBED = ("LD_PRELOAD", "LD_LIBRARY_PATH", "PYTHONPATH_HOST",
             "http_proxy", "https_proxy", "HTTP_PROXY", "HTTPS_PROXY",
             "SSH_AUTH_SOCK")

# Live capsule frames, in entry order.  The old save/clear/restore of the
# whole process environment corrupted it as soon as two capsule runs
# interleaved (A enters, B enters, A's exit restores a snapshot that
# resurrects B's scrubbed vars and drops B's capsule vars).  Instead each
# run owns a composed per-run env *frame*; os.environ is rebuilt from the
# host baseline plus the live frames on every entry/exit, so any exit
# order converges and the last exit restores the host env exactly.
_ACTIVE_FRAMES: List[Dict[str, str]] = []
_HOST_BASELINE: Optional[Dict[str, str]] = None


def _apply_frames() -> None:
    global _HOST_BASELINE
    if _HOST_BASELINE is None:
        return
    merged = dict(_HOST_BASELINE)
    if _ACTIVE_FRAMES:
        for k in _SCRUBBED:
            merged.pop(k, None)
        for frame in _ACTIVE_FRAMES:
            merged.update(frame)
    os.environ.clear()
    os.environ.update(merged)
    if not _ACTIVE_FRAMES:
        _HOST_BASELINE = None


def _accepts_capsule_env(fn: Callable[..., Any]) -> bool:
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    return "capsule_env" in params


@dataclass
class RunResult:
    value: Any
    image: str
    rank: int
    world_size: int
    uid_map: str
    env: Dict[str, str]
    wall_time_s: float


class CapsuleRuntime:
    """``ch-run`` analogue: launch user code inside an unpacked image.

    * verifies the image tree hash before AND after the run (immutability —
      a writeable-image run must opt in like ch-run's ``-w``);
    * scrubs the environment and injects the image's env;
    * simulates the user-namespace uid map (host uid -> container uid 0
      mapping without privilege, paper §II-B);
    * exposes rank/world_size the way Slurm+MPI would.
    """

    def __init__(self, policy: Optional[SecurityPolicy] = None,
                 context: HostContext = CLUSTER):
        self.policy = policy or SecurityPolicy()
        self.policy.admit(RUNTIME_PROFILES["charliecloud"])
        self.context = context

    @staticmethod
    def compose_env(image_dir: Path, manifest: Dict[str, Any],
                    extra_env: Optional[Dict[str, str]] = None
                    ) -> Dict[str, str]:
        """The per-run capsule environment as a plain dict — what ch-run
        would hand the contained process."""
        env = {"REPRO_CAPSULE": manifest["name"],
               "REPRO_CAPSULE_ROOT": str(image_dir),
               "REPRO_NO_NETWORK": "1"}
        env.update(manifest.get("env", {}))
        env.update(extra_env or {})
        return env

    @contextlib.contextmanager
    def _capsule_env(self, image_dir: Path, manifest: Dict[str, Any],
                     extra_env: Optional[Dict[str, str]]):
        global _HOST_BASELINE
        frame = self.compose_env(image_dir, manifest, extra_env)
        if not _ACTIVE_FRAMES:
            _HOST_BASELINE = dict(os.environ)
        _ACTIVE_FRAMES.append(frame)
        _apply_frames()
        try:
            yield frame
        finally:
            _ACTIVE_FRAMES.remove(frame)
            _apply_frames()

    def run(self, image_dir: Path, fn: Callable[..., Any], *args,
            rank: int = 0, world_size: int = 1,
            env: Optional[Dict[str, str]] = None,
            writeable: bool = False, **kwargs) -> RunResult:
        image_dir = Path(image_dir)
        manifest = json.loads((image_dir / "image/manifest.json").read_text())
        pre = _tree_hash(image_dir)
        uid = os.getuid() if hasattr(os, "getuid") else 1000
        t0 = time.perf_counter()
        with self._capsule_env(image_dir, manifest, env) as frame:
            # the composed env is the authoritative per-run scope:
            # functions that declare a ``capsule_env`` parameter receive
            # it directly and stay correct even when another in-process
            # capsule is live concurrently (os.environ then holds the
            # union, last entrant winning on shared keys)
            if _accepts_capsule_env(fn):
                kwargs = {**kwargs, "capsule_env": frame}
            value = fn(*args, **kwargs)
        wall = time.perf_counter() - t0
        if not writeable and _tree_hash(image_dir) != pre:
            raise SecurityError(
                "image tree modified during run without -w (immutability "
                "violation)")
        return RunResult(value, manifest["name"], rank, world_size,
                         uid_map=f"{uid}->0 (user namespace)",
                         env=dict(manifest.get("env", {})),
                         wall_time_s=wall)


def capsule_pip_install(package: str) -> None:
    """What happens if user code tries to install packages inside a capsule
    on the cluster — the paper: "pip install will not succeed"."""
    if os.environ.get("REPRO_NO_NETWORK") == "1":
        raise OfflineViolation(
            f"pip install {package}: no route to pypi.org from the secure "
            "cluster; bake the dependency into the image at build time")
    raise RuntimeError("capsule_pip_install called outside a capsule")
