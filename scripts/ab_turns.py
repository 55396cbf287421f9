"""The turn-taking of the two-tree scripts (``segment_reduce_ab.py``,
``hash_group_ab.py``): one process per tree and turn, parent, change,
change, parent, so that a card's drift falls on both trees alike.

Imported by those scripts; it runs nothing by itself.
"""

import json
import subprocess
import sys

#: one round of turns
ORDER = ("parent", "change", "change", "parent")


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def turns(trees: dict, runs: int, command):
    """For each turn of ``runs`` rounds of ``ORDER``, run the argument
    list ``command(label, turn)`` from the tree ``trees[label]`` and
    yield ``(label, turn, records)``: the JSON lines it printed, each
    echoed as it is read. A turn that fails prints its output to
    standard error and raises ``CalledProcessError``."""
    for turn, label in enumerate(ORDER * runs):
        done = subprocess.run(command(label, turn), capture_output=True,
                              text=True, cwd=trees[label])
        if done.returncode != 0:
            print(done.stdout + done.stderr, file=sys.stderr)
            raise subprocess.CalledProcessError(done.returncode, done.args)
        records = []
        for line in done.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
                records.append(json.loads(line))
        yield label, turn, records
