"""Shared pieces of the port's cluster tests (``test_torch_cluster_exec``,
``test_torch_supervisor``, ``test_torch_chaos``): the cheap shell
payloads the reference's cluster tests use, and cluster builders over
the port's ``launch/cluster.py`` with the command journal in the
cluster root."""

import json

from distributedmnist_tpu_torch.launch.cluster import (LocalClusterConfig,
                                                       LocalProcessCluster)
from distributedmnist_tpu_torch.launch.exec import (CommandExecutor,
                                                    RetryPolicy)

# ~50 ms per step, 400 steps: outlives every test's observation window
STEP_LOOP = ('i=0; while [ $i -lt 400 ]; do i=$((i+1)); '
             'echo "{\\"step\\": $i, \\"loss\\": 1.0}" >> train_log.jsonl; '
             'sleep 0.05; done')

# the same loop with a file "checkpoint" every 5 steps: a restarted
# worker resumes from `ckpt`, and each boot appends its first step to
# boots.txt (the unambiguous resume evidence)
RESUMING_LOOP = ('i=$( [ -f ckpt ] && cat ckpt || echo 0 ); '
                 'echo $i >> boots.txt; '
                 'while [ $i -lt 400 ]; do i=$((i+1)); '
                 'echo "{\\"step\\": $i, \\"loss\\": 1.0}" '
                 '>> train_log.jsonl; '
                 'if [ $((i % 5)) -eq 0 ]; then echo $i > ckpt; fi; '
                 'sleep 0.05; done')

# a standby realization of the resuming loop: signal ready, park until
# the promotion writes the activation file, then adopt the assigned
# worker dir and run the loop there (what `launch train` does natively)
STANDBY_LOOP = (
    'touch "$DMT_STANDBY_ACTIVATION.ready"; '
    'while [ ! -f "$DMT_STANDBY_ACTIVATION" ]; do sleep 0.05; done; '
    'cd "$(python3 -c "import json,os;'
    "print(json.load(open(os.environ['DMT_STANDBY_ACTIVATION']))"
    "['train_dir'])" '")" && ' + RESUMING_LOOP)


def make_cluster(tmp_path, name="c", fault_plan=None, num_workers=2,
                 train_command=STEP_LOOP, retry=None, **cfg_kw):
    cfg = LocalClusterConfig(name=name, workdir=str(tmp_path / "cl"),
                             num_workers=num_workers,
                             train_command=train_command, **cfg_kw)
    ex = CommandExecutor(journal=cfg.root / "command_journal.jsonl",
                         retry=retry or RetryPolicy(max_attempts=1),
                         fault_plan=fault_plan)
    return LocalProcessCluster(cfg, ex)


def worker_steps(cluster, k):
    log = cluster.cfg.worker_dir(k) / "train_log.jsonl"
    return [json.loads(line)["step"] for line in log.read_text().splitlines()]


def boots(cluster, k):
    return [int(x) for x in
            (cluster.cfg.worker_dir(k) / "boots.txt").read_text().split()]
