"""Distributed execution over a ('data', 'model') mesh of torch.distributed
ranks: the mesh (mesh.py), the collectives (comm.py), the brick-sharded
dense march (brick.py) and tile data parallelism with the sharded build,
render and train steps (tile_dp.py)."""
