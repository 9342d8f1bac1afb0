"""Launch entry points: mesh.py (production meshes), steps.py (train /
prefill / decode steps and their placements), dryrun.py (one rank's step
of every arch × shape × mesh, counted on ``meta``), train.py, serve.py,
mine.py."""
