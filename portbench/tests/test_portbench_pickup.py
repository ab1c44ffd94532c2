"""A configuration, a traffic mix, a cell and a metric added as new files
(and entries in BENCHMARK.json) are picked up without editing any file
that is there; a directory that holds only the benchmark runs nothing."""
import json
import shutil

from _runs import ROOT, TINY, result, run


def _copy(tmp_path, with_program=True):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    if with_program:
        shutil.copytree(ROOT / "src", tmp_path / "src",
                        ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_new_files_are_picked_up(tmp_path):
    root = _copy(tmp_path)
    pb = root / "portbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    config = json.loads((pb / "configs" / "hdfs_rs_6_3.json").read_text())
    config.update(name="small_cluster", cluster_nodes=11, backlog_stripes=6,
                  reconstruction_threads=3)
    (pb / "configs" / "small_cluster.json").write_text(json.dumps(config))
    mix = json.loads((pb / "traffic" / "node_loss.json").read_text())
    mix.update(name="node_loss_ppr", scheme="ppr")
    (pb / "traffic" / "node_loss_ppr.json").write_text(json.dumps(mix))
    cell = dict(name="small_ppr", config="small_cluster", traffic="node_loss_ppr",
                chips=1, why="a cell added as files")
    (pb / "workloads" / "small_ppr.json").write_text(json.dumps(cell))
    (pb / "metrics" / "batches_run.py").write_text(
        'UNIT, BETTER, SOURCE = "1", "higher", "host_clock"\n\n\n'
        "def read(run):\n    return len(run.batches)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(cell)
    bench["end_to_end"].append(dict(name="batches_run", unit="1", better="higher",
                                    bound=0.25, source="host_clock",
                                    workloads=["small_ppr"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all(p.read_bytes() == b for p, b in before.items())

    res, _ = result(["--workload", "small_ppr", "--seed", "3", "--seconds", "1",
                     "--trace", "0", *TINY], root=root)
    assert res["correct"] is True
    assert res["metrics"]["batches_run"]["value"] >= 1
    assert res["attempted"] % 3 == 0


def test_benchmark_alone_runs_nothing(tmp_path):
    root = _copy(tmp_path, with_program=False)
    code, out, err = run(["--workload", "rs63_node_loss", "--seed", "1",
                          "--seconds", "1", "--trace", "0", *TINY], root=root)
    assert code != 0
    assert not any(line.startswith("{\"correct\"") for line in out)
    assert any("cannot import" in line for line in err)
