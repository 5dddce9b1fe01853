# Launchers: the serving driver (serve.py), the training driver (train.py)
# and the meshes (mesh.py).
