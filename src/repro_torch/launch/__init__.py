# Launchers: the serving driver (serve.py).  Training (train.py), the mesh
# and the dry run wait for ROADMAP.md, Queue 1 items 8b and 8c.
