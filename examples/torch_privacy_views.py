"""Privacy-preserving mining on the PyTorch port (the paper's §2.2 COVID
example, §6.2 claims): the program of ``examples/privacy_views.py`` on
``repro_torch``, printing the same lines in the same order.  An analyst
session can ONLY obtain aggregates, through an access-control view that
coarsens activities to the department level; its queries run on an engine
on ``--device`` (the card by default, with no fallback to the host).

    PYTHONPATH=src python examples/torch_privacy_views.py
    PYTHONPATH=src python examples/torch_privacy_views.py --device cpu
"""

import argparse

from repro_torch.core import (
    AccessPolicy,
    ActivityView,
    AnalystSession,
    EventRepository,
)
from repro_torch.core.views import AccessDenied
from repro_torch.device import resolve_device
from repro_torch.query import QueryEngine

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
device = resolve_device(ap.parse_args().device)

# a hospital-ish process: activity names carry ward-level detail
repo = EventRepository.from_traces(
    [
        ["reg_desk_A", "triage_room_2", "lab_blood", "ward_3_admit"],
        ["reg_desk_B", "triage_room_1", "lab_xray", "ward_3_admit"],
        ["reg_desk_A", "triage_room_1", "lab_blood", "ward_5_admit"],
    ]
    * 50
)

view = ActivityView(
    mapping={
        "reg_desk_A": "registration", "reg_desk_B": "registration",
        "triage_room_1": "triage", "triage_room_2": "triage",
        "lab_blood": "lab", "lab_xray": "lab",
        "ward_3_admit": "admission", "ward_5_admit": "admission",
    }
)
policy = AccessPolicy(aggregate_only=True, view=view, min_group_count=5)
session = AnalystSession(repo, policy, engine=QueryEngine(device=device))

psi, names = session.dfg()
print("analyst sees the department-level DFG only:")
print("               " + "  ".join(f"{n:>12}" for n in names))
for n, row in zip(names, psi):
    print(f"{n:>14} " + "  ".join(f"{int(x):12d}" for x in row))

print("\nraw events are unreachable through the session:")
try:
    session.events()
except AccessDenied as e:
    print(f"  AccessDenied: {e}")

hist, hnames = session.activity_histogram()
print("\ncoarsened histogram:", dict(zip(hnames, hist.tolist())))
print("trace stats (aggregate):", session.trace_length_stats())
