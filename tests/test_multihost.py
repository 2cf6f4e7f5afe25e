"""Multi-host integration: TWO real processes, one coordinator, one output.

Launches two OS processes that jax.distributed.initialize against a local
coordinator (CPU backend), each polishing its round-robin share of batches
(parallel/distributed batch ownership); host 0's reaper merges the
per-batch files strictly in order.  The merged output must be byte-identical
to a plain single-host run, across real processes.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from goldpolish_tpu.io import fasta


def _scenario(tmp_path, n_contigs=4, contig_len=3000, coverage=8):
    rng = np.random.default_rng(11)
    truths = [
        "".join(rng.choice(list("ACGT"), contig_len)) for _ in range(n_contigs)
    ]
    draft = str(tmp_path / "draft.fa")
    reads = str(tmp_path / "reads.fa")
    paf = str(tmp_path / "map.paf")
    with open(draft, "w") as d:
        for i, t in enumerate(truths):
            s = list(t)
            s[contig_len // 2] = "A" if s[contig_len // 2] != "A" else "C"
            d.write(f">ctg{i}\n{''.join(s)}\n")
    rid = 0
    with open(reads, "w") as r, open(paf, "w") as p:
        for i, t in enumerate(truths):
            for _c in range(coverage):
                r.write(f">r{rid}\n{t}\n")
                p.write(
                    f"r{rid}\t{contig_len}\t0\t{contig_len}\t+\tctg{i}\t"
                    f"{contig_len}\t0\t{contig_len}\t{contig_len}\t"
                    f"{contig_len}\t60\n"
                )
                rid += 1
    return draft, reads, paf


_RUN_SCRIPT = """
import sys
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
from goldpolish_tpu.config import PipelineConfig
from goldpolish_tpu.pipeline import bulk

cfg = PipelineConfig(
    seqs_to_polish={draft!r}, polishing_seqs={reads!r},
    output_seqs={out!r}, mappings_path={paf!r},
    k_values=[32], batch_size=1, run_sealer=False,
    workspace={ws!r},
)
bulk.run_bulk(cfg)
"""


@pytest.mark.slow
def test_two_process_bulk_matches_single_host(tmp_path):
    draft, reads, paf = _scenario(tmp_path)

    # single-host reference output
    from goldpolish_tpu.config import PipelineConfig
    from goldpolish_tpu.pipeline import bulk

    ref_out = str(tmp_path / "ref.fa")
    bulk.run_bulk(PipelineConfig(
        seqs_to_polish=draft, polishing_seqs=reads, output_seqs=ref_out,
        mappings_path=paf, k_values=[32], batch_size=1, run_sealer=False,
        workspace=str(tmp_path / "ws_ref"),
    ))
    ref = open(ref_out).read()

    # free port for the coordinator
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    out = str(tmp_path / "multi.fa")
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            JAX_NUM_PROCESSES="2",
            JAX_PROCESS_ID=str(pid),
        )
        script = _RUN_SCRIPT.format(
            repo=os.getcwd(), draft=draft, reads=reads, paf=paf, out=out,
            ws=str(tmp_path / f"ws{pid}"),
        )
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    fails = []
    for pid, p in enumerate(procs):
        try:
            _o, e = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            _o, e = p.communicate()
            fails.append((pid, "timeout", e[-2000:]))
            continue
        if p.returncode != 0:
            fails.append((pid, p.returncode, e[-2000:]))
    assert not fails, fails
    got = open(out).read()
    assert got == ref  # ordered, byte-identical merged output
    recs = [r.id for r in fasta.read_seqs(out)]
    assert recs == [f"ctg{i}" for i in range(4)]
