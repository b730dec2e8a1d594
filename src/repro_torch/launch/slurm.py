"""Slurm submission-script generation (paper §IV-B/C command lines; the
port's own copy of ``repro.launch.slurm``: the same template, byte for
byte, whose payload is the port's launcher,
``python -m repro_torch.launch.train``).

Renders sbatch scripts whose payload is the paper's exact launch pattern:

  single node (OpenMP inside the capsule):
      ch-run <image> -- python <script>
  multi node (hybrid MPI x OpenMP, one rank per node, 2 threads/core):
      mpiexec -n $SLURM_NTASKS -ppn 1 ch-run <image> -- python <script>
"""
from __future__ import annotations

import shlex
from typing import Dict, Optional

_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={job_name}
#SBATCH --nodes={nodes}
#SBATCH --ntasks-per-node={ranks_per_node}
#SBATCH --cpus-per-task={threads_per_rank}
#SBATCH --time={walltime}
#SBATCH --partition={partition}
#SBATCH --export=NONE
# SuperMUC-NG: no internet on login/compute nodes; image must already be
# staged (ch-tar2dir) under node-local storage.

module load slurm_setup
export OMP_NUM_THREADS={omp_threads}
export KMP_AFFINITY=granularity=fine,compact
export KMP_BLOCKTIME=1
{extra_env}
{launch_line}
"""


def render_script(job_name: str, image_dir: str, entrypoint: str,
                  nodes: int = 1, ranks_per_node: int = 1,
                  threads_per_rank: int = 96, walltime: str = "08:00:00",
                  partition: str = "general", script: str = "train.py",
                  env: Optional[Dict[str, str]] = None) -> str:
    total_ranks = nodes * ranks_per_node
    if nodes == 1 and ranks_per_node == 1:
        # paper §IV-B: single node, OpenMP parallelism inside the capsule
        launch = f"ch-run {image_dir} -- {entrypoint} {script}"
    else:
        # paper §IV-C: hybrid MPI x OpenMP, one rank per node
        launch = (f"mpiexec -n {total_ranks} -ppn {ranks_per_node} "
                  f"ch-run {image_dir} -- {entrypoint} {script}")
    # values are shell-quoted (spool paths and JSON blobs carry spaces and
    # quotes); OMP threads clamp to >=1 — hyperthread halving of a single
    # CPU rank must not render OMP_NUM_THREADS=0
    extra = "\n".join(f"export {k}={shlex.quote(str(v))}"
                      for k, v in (env or {}).items())
    return _TEMPLATE.format(
        job_name=job_name, nodes=nodes, ranks_per_node=ranks_per_node,
        threads_per_rank=threads_per_rank, walltime=walltime,
        partition=partition, omp_threads=max(1, threads_per_rank // 2),
        extra_env=extra, launch_line=launch)
