"""``tools/launch.py --fleet_collector`` over two CPU ranks of
``cifar_app``: the launcher's collector merges both ranks' shipped
series, and its end-of-run summary reads both hosts, none late or dead
(each finished: its shipper sent the final push on a clean exit).
The ranks join through a ``file://`` store; the collector binds an
ephemeral loopback port.  With ``--trace_out`` each rank writes its own
trace (rank 1: ``TRACE.p1.json``)."""

import json

from sparknet_tpu_torch.tools import launch

ROUNDS = 2


def test_launch_fleet_collector_two_cpu_ranks(tmp_path, monkeypatch, capsys):
    seen = {}
    summary = launch.print_fleet_summary

    def capture(collector):
        seen["view"] = collector.fleet_view()
        seen["text"] = collector.render_metrics()
        summary(collector)

    monkeypatch.setattr(launch, "print_fleet_summary", capture)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.chdir(tmp_path)
    rc = launch.main([
        "--nprocs", "2", "--coordinator", "file://" + str(tmp_path / "store"),
        "--fleet_collector", "127.0.0.1:0", "--timeout", "300",
        "cifar", "--device", "cpu", "--workers", "2", "--tau", "1",
        "--rounds", str(ROUNDS), "--test_every", "100", "--batch", "20",
        "--trace_out", str(tmp_path / "trace.json")])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "launch: fleet collector on http://127.0.0.1:" in out
    assert ("launch: fleet summary — 2 host(s): 0 live, 0 late, 0 dead, "
            "2 finished" in out), out
    view = seen["view"]
    assert sorted(view["hosts"]) == ["host0", "host1"]
    for h, st in view["hosts"].items():
        assert st["state"] == "finished", (h, st)
        assert st["round"] == ROUNDS - 1, (h, st)  # the last round's index
        assert st["lost_events"] == 0 and st["reported_dropped_total"] == 0
        assert st["counters"]["sparknet_rounds_total"] == ROUNDS, (h, st)
        assert f"launch:   {h} is finished (round {ROUNDS - 1}" in out
    merged = view["fleet"]["counters"]["sparknet_rounds_total"]
    assert merged == sum(st["counters"]["sparknet_rounds_total"]
                         for st in view["hosts"].values()) == 2 * ROUNDS
    assert 'sparknet_rounds_total{host="fleet"} 4' in seen["text"]
    # one trace file a rank, each with every round's phases
    for name in ("trace.json", "trace.p1.json"):
        with open(tmp_path / name) as f:
            rounds = {e["args"]["round"] for e in json.load(f)["traceEvents"]
                      if e.get("name") == "assemble"}
        assert rounds == set(range(ROUNDS)), name
