"""Stream sharding over a device mesh (mesh.py) and its dry run
(dryrun.py)."""
