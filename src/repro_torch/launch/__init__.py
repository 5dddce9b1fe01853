# Launchers: the serving driver (serve.py) and the training driver
# (train.py).  The mesh and the dry run wait for ROADMAP.md, Queue 1 item 8c.
