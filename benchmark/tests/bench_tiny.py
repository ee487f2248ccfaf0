"""Running a cell in this process at the tiny CPU shapes of ``data/``."""

import json
from pathlib import Path

DATA = Path(__file__).resolve().parent / "data"


def args(kind: str):
    return ["--device", "cpu",
            "--config-file", str(DATA / f"{kind}_config.json"),
            "--traffic-file", str(DATA / f"{kind}_traffic.json")]


def run_cell(capsys, workload: str, kind: str, seed: int, trace: int = 0,
             seconds: float = 0.5) -> dict:
    """The result line of one run (``run.main``) as a dict."""
    import run
    rc = run.main(["--workload", workload, "--seed", str(seed),
                   "--seconds", str(seconds), "--trace", str(trace)]
                  + args(kind))
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])
