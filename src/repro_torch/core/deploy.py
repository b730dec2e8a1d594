"""End-to-end deployment pipeline — the paper's §III-B/§IV workflow as code
(the port's own copy of ``repro.core.deploy``, which imports no framework).

``DeploymentPipeline.deploy()`` executes the full Charliecloud sequence:

    build (workstation) -> flatten -> transfer -> unpack (cluster)
    -> generate the Slurm submission script -> launch via CapsuleRuntime

and returns a ``Deployment`` handle whose ``run()`` executes user entrypoints
inside the capsule with Slurm/MPI-style rank env.  This is the object the
examples and the container-overhead benchmark drive.  The script's payload
is the port's launcher; the image they deploy is :func:`pytorch_image`,
whose requirements resolve against the port's offline index.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core import container as cc
from repro_torch.core.registry import PackageIndex, default_index


@dataclass
class Deployment:
    image: cc.Image
    archive: Path
    unpacked: Path
    runtime: cc.CapsuleRuntime
    slurm_script: str
    log: List[str] = field(default_factory=list)

    def run(self, fn: Callable[..., Any], *args, ranks: int = 1,
            env: Optional[Dict[str, str]] = None, **kwargs) -> List[cc.RunResult]:
        """Launch ``fn`` on ``ranks`` ranks (sequentially here — one host),
        each inside the capsule with its Slurm/MPI rank env.  A function
        that makes a process group of ``ranks`` members would wait here
        for ranks that never start: a multi-rank run is one process per
        rank, each calling ``runtime.run`` on ``unpacked``, as ``mpiexec
        ... ch-run`` starts them."""
        results = []
        for r in range(ranks):
            rank_env = dict(env or {})
            rank_env.update({
                "SLURM_PROCID": str(r), "SLURM_NTASKS": str(ranks),
                "OMPI_COMM_WORLD_RANK": str(r),
                "OMPI_COMM_WORLD_SIZE": str(ranks),
            })
            results.append(self.runtime.run(
                self.unpacked, fn, *args, rank=r, world_size=ranks,
                env=rank_env, **kwargs))
        return results


# what the Slurm script's ``ch-run`` starts on every rank
LAUNCHER = "-m repro_torch.launch.train"


class DeploymentPipeline:
    def __init__(self, index: Optional[PackageIndex] = None,
                 policy: Optional[cc.SecurityPolicy] = None,
                 workstation: cc.HostContext = cc.WORKSTATION,
                 cluster: cc.HostContext = cc.CLUSTER):
        self.index = index or default_index()
        self.policy = policy or cc.SecurityPolicy()
        self.workstation = workstation
        self.cluster = cluster

    def deploy(self, definition: cc.ImageDefinition, work_dir: Path,
               nodes: int = 1, ranks_per_node: int = 1,
               threads_per_rank: int = 96,
               script: str = LAUNCHER) -> Deployment:
        work_dir = Path(work_dir)
        log = []
        # 1. ch-build on the workstation (deps resolved against the index)
        builder = cc.ImageBuilder(self.index, self.workstation)
        image = builder.build(definition)
        log.append(f"ch-build: {image.definition.name} "
                   f"({len(image.packages)} packages, {image.content_hash[:12]})")
        # 2. ch-docker2tar
        archive = cc.flatten(image, work_dir / "workstation")
        log.append(f"ch-docker2tar: {archive.name} "
                   f"({archive.stat().st_size} bytes)")
        # 3. scp across the air gap
        staged = cc.transfer(archive, work_dir / "cluster" / "inbox")
        log.append(f"transfer: {staged}")
        # 4. ch-tar2dir into node-local storage
        unpacked = cc.unpack(staged, work_dir / "cluster" / "tmpfs",
                             self.cluster)
        log.append(f"ch-tar2dir: {unpacked}")
        # 5. Slurm submission script (paper §IV-B/C command lines)
        from repro_torch.launch import slurm
        sbatch = slurm.render_script(
            job_name=definition.name, image_dir=str(unpacked),
            entrypoint=definition.entrypoint, nodes=nodes,
            ranks_per_node=ranks_per_node, threads_per_rank=threads_per_rank,
            script=script)
        log.append(f"sbatch script: {len(sbatch.splitlines())} lines")
        runtime = cc.CapsuleRuntime(self.policy, self.cluster)
        return Deployment(image, staged, unpacked, runtime, sbatch, log)


def intel_tensorflow_image(name: str = "intel-tf-horovod") -> cc.ImageDefinition:
    """The paper's exact image: Intel-optimized TF from the Intel AI Docker
    Hub, plus MPI and Horovod baked in at build time (§III-B)."""
    return cc.ImageDefinition(
        name=name,
        base="intelaipg/intel-optimized-tensorflow:1.11.0",
        requirements=("intel-tensorflow==1.11.0", "horovod>=0.15.0",
                      "mpi4py>=3.0.0", "keras>=2.2.0"),
        env={"OMP_NUM_THREADS": "48", "KMP_AFFINITY": "granularity=fine,compact",
             "KMP_BLOCKTIME": "1"},
        entrypoint="python",
        labels={"paper": "HPEC-2019-Brayford", "site": "LRZ"})


def pytorch_image(name: str = "repro-torch") -> cc.ImageDefinition:
    """The port's image: PyTorch and this package, baked in at build time
    and resolved against the port's offline index.  A CUDA development
    base, since the kernels are built with ``nvcc`` at their first use on
    the node; the env names the toolkit, as such an image does."""
    return cc.ImageDefinition(
        name=name,
        base="pytorch/pytorch:2.11.0-cuda12.8-cudnn9-devel",
        requirements=("repro-torch==0.1.0", "torch>=2.0.0",
                      "mpi4py>=3.0.0"),
        env={"CUDA_HOME": "/usr/local/cuda"},
        entrypoint="python",
        labels={"paper": "HPEC-2019-Brayford", "framework": "pytorch"})
