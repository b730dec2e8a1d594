"""The port's capsule, registry, deployment and Slurm modules: every case of
``tests/test_container.py`` and ``tests/test_registry.py`` on the port's
copies, then the two packages against each other (the same manifest and
content hash for the same definition, archives that run under either
runtime, byte-identical Slurm scripts, equal resolutions), the port's
launcher inside a capsule, and the two new examples.

Every comparison here is exact: the modules are framework-free data
handling, and the launcher in and out of the capsule runs the same code on
the same inputs, so its losses must be equal bit for bit.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import container as JC
from repro.core import deploy as JD
from repro.core import registry as JR
from repro.launch import slurm as JS
from repro_torch import bridge
from repro_torch.core import container as C
from repro_torch.core import deploy as D
from repro_torch.core import registry as R
from repro_torch.core.registry import OfflineViolation, default_index
from repro_torch.launch import slurm

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def pipeline():
    return D.DeploymentPipeline(index=default_index())


# ---------------------------------------------------------------------------
# tests/test_container.py, on the port's modules
# ---------------------------------------------------------------------------

def test_build_requires_workstation():
    builder = C.ImageBuilder(default_index(), context=C.CLUSTER)
    with pytest.raises(OfflineViolation):
        builder.build(C.ImageDefinition("x", requirements=("numpy>=1.14",)))


@pytest.mark.parametrize("image", ["intel_tensorflow_image", "pytorch_image"])
def test_full_pipeline_and_run(tmp_path, pipeline, image):
    dep = pipeline.deploy(getattr(D, image)("t1"), tmp_path, nodes=4)
    assert dep.archive.exists() and dep.unpacked.exists()
    assert "mpiexec -n 4 -ppn 1 ch-run" in dep.slurm_script
    # the payload is the port's launcher
    assert dep.slurm_script.splitlines()[-1].endswith(
        "-- python -m repro_torch.launch.train")
    res = dep.run(lambda: os.environ["REPRO_CAPSULE"], ranks=3)
    assert [r.value for r in res] == ["t1"] * 3
    assert res[1].rank == 1 and res[1].world_size == 3


def test_env_scrubbed_and_restored(tmp_path, pipeline):
    dep = pipeline.deploy(D.pytorch_image("t2"), tmp_path)
    os.environ["SSH_AUTH_SOCK"] = "/tmp/ssh-evil"
    try:
        res = dep.run(lambda: os.environ.get("SSH_AUTH_SOCK", "SCRUBBED"))
        assert res[0].value == "SCRUBBED"
        assert os.environ["SSH_AUTH_SOCK"] == "/tmp/ssh-evil"  # restored
    finally:
        del os.environ["SSH_AUTH_SOCK"]


def test_pip_inside_capsule_dies(tmp_path, pipeline):
    dep = pipeline.deploy(D.pytorch_image("t3"), tmp_path)
    with pytest.raises(OfflineViolation):
        dep.run(lambda: C.capsule_pip_install("pandas"))
    with pytest.raises(RuntimeError, match="outside a capsule"):
        C.capsule_pip_install("pandas")


def test_image_immutability(tmp_path, pipeline):
    dep = pipeline.deploy(D.pytorch_image("t4"), tmp_path)

    def vandalize():
        root = Path(os.environ["REPRO_CAPSULE_ROOT"])
        (root / "image" / "manifest.json").write_text("{}")
        return True

    with pytest.raises(C.SecurityError, match="immutability"):
        dep.run(vandalize)
    # with -w (writeable) it is allowed, like ch-run -w
    dep2 = pipeline.deploy(D.pytorch_image("t5"), tmp_path)
    dep2.runtime.run(dep2.unpacked, vandalize, writeable=True)


def test_unpack_refuses_hash_mismatch(tmp_path):
    b = C.ImageBuilder(default_index())
    img1 = b.build(C.ImageDefinition("same-name",
                                     requirements=("numpy>=1.14",)))
    img2 = b.build(C.ImageDefinition("same-name",
                                     requirements=("six>=1.10",)))
    a1 = C.flatten(img1, tmp_path / "w1")
    a2 = C.flatten(img2, tmp_path / "w2")
    C.unpack(a1, tmp_path / "tmpfs")
    C.unpack(a1, tmp_path / "tmpfs")        # the same build: replaced
    with pytest.raises(C.SecurityError, match="hash mismatch"):
        C.unpack(a2, tmp_path / "tmpfs")


def test_unpack_refuses_partial_tree(tmp_path):
    """A crashed prior ch-tar2dir leaves a partial dest (no manifest, a
    corrupt one, one without a hash): each is refused as a hash
    mismatch."""
    img = C.ImageBuilder(default_index()).build(
        C.ImageDefinition("partial", requirements=("numpy>=1.14",)))
    archive = C.flatten(img, tmp_path / "w")
    dest = tmp_path / "tmpfs" / "partial"
    dest.mkdir(parents=True)
    with pytest.raises(C.SecurityError, match="hash mismatch"):
        C.unpack(archive, tmp_path / "tmpfs")
    (dest / "image").mkdir()
    for text in ("{truncated", "{}"):
        (dest / "image/manifest.json").write_text(text)
        with pytest.raises(C.SecurityError, match="hash mismatch"):
            C.unpack(archive, tmp_path / "tmpfs")


def test_interleaved_capsule_env_frames(tmp_path, pipeline):
    """A enters, B enters, A exits, B exits: B's frame survives A's exit,
    scrubbed vars stay scrubbed while any frame is live, and the last exit
    restores the host environment exactly."""
    dep_a = pipeline.deploy(D.pytorch_image("cap-a"), tmp_path)
    dep_b = pipeline.deploy(D.pytorch_image("cap-b"), tmp_path)
    os.environ["SSH_AUTH_SOCK"] = "/tmp/ssh-interleave"
    try:
        baseline = dict(os.environ)
        rt = dep_a.runtime
        man_a = json.loads(
            (dep_a.unpacked / "image/manifest.json").read_text())
        man_b = json.loads(
            (dep_b.unpacked / "image/manifest.json").read_text())
        cm_a = rt._capsule_env(dep_a.unpacked, man_a, None)
        cm_b = rt._capsule_env(dep_b.unpacked, man_b, None)
        cm_a.__enter__()
        assert os.environ["REPRO_CAPSULE"] == "cap-a"
        cm_b.__enter__()
        assert os.environ["REPRO_CAPSULE"] == "cap-b"
        cm_a.__exit__(None, None, None)
        assert os.environ["REPRO_CAPSULE"] == "cap-b"
        assert os.environ["REPRO_CAPSULE_ROOT"] == str(dep_b.unpacked)
        assert "SSH_AUTH_SOCK" not in os.environ
        cm_b.__exit__(None, None, None)
        assert dict(os.environ) == baseline
    finally:
        os.environ.pop("SSH_AUTH_SOCK", None)


def test_fn_receives_composed_capsule_env(tmp_path, pipeline):
    dep = pipeline.deploy(D.pytorch_image("t6"), tmp_path)
    res = dep.runtime.run(
        dep.unpacked,
        lambda capsule_env: (capsule_env["REPRO_CAPSULE"],
                             capsule_env["REPRO_NO_NETWORK"],
                             capsule_env["CUDA_HOME"], capsule_env["EXTRA"]),
        env={"EXTRA": "1"})
    assert res.value == ("t6", "1", "/usr/local/cuda", "1")


def test_site_policy_rejects_docker_singularity_admits_charliecloud():
    pol = C.SecurityPolicy()
    for name in ("docker", "singularity", "shifter"):
        with pytest.raises(C.SecurityError):
            pol.admit(C.RUNTIME_PROFILES[name])
    pol.admit(C.RUNTIME_PROFILES["charliecloud"])  # no raise


def test_slurm_script_single_vs_multi():
    s1 = slurm.render_script("j", "/img", "python", nodes=1)
    assert "mpiexec" not in s1 and "ch-run /img" in s1
    s2 = slurm.render_script("j", "/img", "python", nodes=16)
    assert "mpiexec -n 16 -ppn 1 ch-run /img" in s2


def test_slurm_omp_threads_clamp():
    s = slurm.render_script("j", "/img", "python", threads_per_rank=96)
    assert "export OMP_NUM_THREADS=48" in s
    s1 = slurm.render_script("j", "/img", "python", threads_per_rank=1)
    assert "export OMP_NUM_THREADS=1" in s1


def test_slurm_env_values_are_shell_quoted():
    s = slurm.render_script(
        "j", "/img", "python",
        env={"SPOOL": "/tmp/my spool/dir",
             "SPEC": '{"config": "qwen2-0.5b"}'})
    assert "export SPOOL='/tmp/my spool/dir'" in s
    assert """export SPEC='{"config": "qwen2-0.5b"}'""" in s


# ---------------------------------------------------------------------------
# tests/test_registry.py, on the port's module
# ---------------------------------------------------------------------------

def test_version_parsing():
    assert R.parse_version("1.11.0") == (1, 11, 0)
    assert R.parse_version("2.6") == (2, 6, 0)
    c = R.Constraint.parse(">=3.6.0")
    assert c.satisfied_by((3, 6, 1)) and not c.satisfied_by((3, 5, 9))
    with pytest.raises(ValueError):
        R.parse_version("1.x")


def test_resolver_picks_consistent_set():
    sol = R.Resolver(default_index()).resolve(
        ["tensorflow==1.11.0", "horovod>=0.15.0"])
    assert sol["tensorflow"].version == "1.11.0"
    assert sol["protobuf"].vtuple >= (3, 6, 0)
    assert "six" in sol and "numpy" in sol


def test_conflicting_roots_unresolvable_in_one_env():
    with pytest.raises(R.ResolutionError):
        R.Resolver(default_index()).resolve(
            ["tensorflow==1.11.0", "caffe==1.0.0"])


def test_paper_tf_then_caffe_breakage():
    env = R.SharedEnvironment(default_index())
    env.pip_install("tensorflow==1.11.0")
    assert env.check() == {}
    env.pip_install("caffe==1.0.0")
    problems = env.check()
    assert "tensorflow==1.11.0" in problems
    assert any("protobuf" in p for p in problems["tensorflow==1.11.0"])


def test_per_image_resolution_fixes_it():
    r = R.Resolver(default_index())
    assert r.resolve(["tensorflow==1.11.0"])["protobuf"].vtuple >= (3, 6, 0)
    assert r.resolve(["caffe==1.0.0"])["protobuf"].version == "2.6.1"


def test_offline_fetch_raises():
    with pytest.raises(R.OfflineViolation):
        R.Resolver(R.PackageIndex()).resolve(["pandas>=1.0.0"])


def test_port_index_swaps_the_reference_package_for_a_pytorch_image():
    idx, ref = default_index(), JR.default_index()
    assert not idx.versions("jax-repro") and ref.versions("jax-repro")
    pins = R.Resolver(idx).resolve(list(D.pytorch_image().requirements))
    assert {k: s.version for k, s in pins.items()} == {
        "repro-torch": "0.1.0", "torch": "2.11.0", "numpy": "1.15.4",
        "mpi4py": "3.0.0"}
    with pytest.raises(JR.OfflineViolation):
        JR.Resolver(ref).resolve(list(D.pytorch_image().requirements))


# ---------------------------------------------------------------------------
# the two packages against each other
# ---------------------------------------------------------------------------

PAPER_REQUIREMENT_SETS = [
    ["tensorflow==1.11.0"], ["caffe==1.0.0"],
    ["tensorflow==1.11.0", "horovod>=0.15.0"],
    list(JD.intel_tensorflow_image().requirements),
    ["keras>=2.2.0", "mpi4py>=3.0.0"], ["numpy>=1.14.0,<1.15.0"]]


@pytest.mark.parametrize("reqs", PAPER_REQUIREMENT_SETS,
                         ids=[",".join(r) for r in PAPER_REQUIREMENT_SETS])
def test_both_indexes_resolve_the_paper_sets_to_the_same_pins(reqs):
    got = R.Resolver(default_index()).resolve(reqs)
    want = JR.Resolver(JR.default_index()).resolve(reqs)
    assert {k: s.version for k, s in got.items()} == {
        k: s.version for k, s in want.items()}


def test_reference_index_entries_kept_number_for_number():
    idx, ref = default_index(), JR.default_index()
    names = set(ref._pkgs) - {"jax-repro"}
    for name in names:
        assert [dataclasses.astuple(s) for s in idx.versions(name)] == [
            dataclasses.astuple(s) for s in ref.versions(name)], name


def _both_builds(definition):
    """The definition built by the port and by the reference, each with
    the port's index (the reference's index has no torch)."""
    port = C.ImageBuilder(default_index()).build(definition)
    ref = JC.ImageBuilder(default_index()).build(
        JC.ImageDefinition(**dataclasses.asdict(definition)))
    return port, ref


@pytest.mark.parametrize("image", ["intel_tensorflow_image", "pytorch_image"])
def test_same_definition_gives_same_manifest_and_hash(image):
    port, ref = _both_builds(getattr(D, image)())
    assert port.manifest() == ref.manifest()
    assert port.content_hash == ref.content_hash
    # and the reference's own pipeline on its own index, for its image
    if image == "intel_tensorflow_image":
        own = JC.ImageBuilder(JR.default_index()).build(
            JD.intel_tensorflow_image())
        assert own.content_hash == port.content_hash


@pytest.mark.parametrize("direction", ["reference->port", "port->reference"])
def test_archives_run_under_either_runtime(tmp_path, direction):
    port, ref = _both_builds(D.pytorch_image("cross"))
    if direction == "reference->port":
        archive = JC.flatten(ref, tmp_path / "ws")
        dest = C.unpack(JC.transfer(archive, tmp_path / "inbox"),
                        tmp_path / "tmpfs")
        runtime = C.CapsuleRuntime()
    else:
        archive = C.flatten(port, tmp_path / "ws")
        dest = JC.unpack(C.transfer(archive, tmp_path / "inbox"),
                         tmp_path / "tmpfs")
        runtime = JC.CapsuleRuntime()
    # the same tree from either package's flatten and unpack
    other = (C.flatten(port, tmp_path / "again") if direction ==
             "reference->port" else JC.flatten(ref, tmp_path / "again"))
    pre = C._tree_hash(dest)
    assert JC._tree_hash(C.unpack(other, tmp_path / "other")) == pre
    res = runtime.run(dest, lambda: (os.environ["REPRO_CAPSULE"],
                                     os.environ["REPRO_NO_NETWORK"],
                                     os.environ["CUDA_HOME"]))
    assert res.value == ("cross", "1", "/usr/local/cuda")
    assert JC._tree_hash(dest) == pre
    with pytest.raises(OfflineViolation if direction == "reference->port"
                       else JR.OfflineViolation):
        runtime.run(dest, C.capsule_pip_install if direction ==
                    "reference->port" else JC.capsule_pip_install, "pandas")


SLURM_CASES = {
    "1-node": dict(nodes=1),
    "32x1": dict(nodes=32, ranks_per_node=1, threads_per_rank=96),
    "env": dict(nodes=2, ranks_per_node=4, threads_per_rank=1,
                walltime="00:30:00", partition="test", script="-m x --y 1",
                env={"SPOOL": "/tmp/my spool/dir",
                     "SPEC": '{"config": "qwen2-0.5b", "n": 2}'}),
}


@pytest.mark.parametrize("case", list(SLURM_CASES))
def test_slurm_scripts_are_byte_identical(case):
    kw = SLURM_CASES[case]
    assert slurm.render_script("job", "/tmpfs/img", "python", **kw) == \
        JS.render_script("job", "/tmpfs/img", "python", **kw)


def test_pipeline_script_matches_reference_render(tmp_path, pipeline):
    dep = pipeline.deploy(D.pytorch_image(), tmp_path, nodes=32)
    assert dep.slurm_script == JS.render_script(
        job_name="repro-torch", image_dir=str(dep.unpacked),
        entrypoint="python", nodes=32, script=D.LAUNCHER)


# ---------------------------------------------------------------------------
# the launcher inside the capsule; the examples
# ---------------------------------------------------------------------------

def test_launcher_inside_capsule_equals_bare(tmp_path, pipeline):
    from repro_torch.launch import train
    argv = ["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
            "--strategy", "dp", "--steps", "3", "--seq-len", "24",
            "--global-batch", "4"]
    bare = train.main(argv)
    dep = pipeline.deploy(D.pytorch_image("lm"), tmp_path)
    pre = C._tree_hash(dep.unpacked)
    res = dep.run(train.main, argv)[0]
    assert C._tree_hash(dep.unpacked) == pre
    inside = res.value
    assert inside["losses"] == bare["losses"]            # bit for bit
    assert inside["world_size"] == 1 and inside["backend"] == "gloo"
    got, want = (bridge.to_flat(r["params"]) for r in (inside, bare))
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    n = sum(v.size for v in want.values())
    # one fused gradient all_reduce and the metrics' (loss, ce_loss,
    # aux_loss, perplexity) a step
    assert inside["collectives_per_step"] == [
        {"calls": 2, "bytes": 4 * n + 16}] * 3


def _example(name, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                        *args], capture_output=True, text=True, env=env,
                       cwd=str(ROOT), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_torch_quickstart_example_on_the_cpu():
    out = _example("torch_quickstart.py", "--device", "cpu", "--smoke")
    assert "ch-build: quickstart" in out
    assert "mpiexec -n 4 -ppn 1 ch-run" in out
    assert "-- python -m repro_torch.launch.train --arch qwen2-0.5b " \
        "--strategy dp --device cpu" in out
    assert "world_size=1 backend=gloo" in out
    assert "(DOWN)" in out and "capsule run complete" in out


def test_torch_deploy_supermuc_example_on_the_cpu():
    out = _example("torch_deploy_supermuc.py", "--device", "cpu")
    assert "BROKEN tensorflow" in out
    assert "OfflineViolation" in out
    assert "charliecloud: ADMITTED" in out and "docker: refused" in out
    assert "'torch': '2.11.0'" in out
    assert "2 ones summed on cpu" in out
    assert "mpiexec -n 32 -ppn 1 ch-run" in out
    assert out.rstrip().endswith("-- python -m repro_torch.launch.train")
