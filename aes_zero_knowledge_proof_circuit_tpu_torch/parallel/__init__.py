"""Multi-device proving: the mesh (`mesh.py`), the four-step sharded NTT
(`sharded_ntt.py`), the point-sharded MSM (`sharded_msm.py`) and a check of
all three on small shapes (`dryrun.py`); counterpart of the JAX package's
`parallel/`. Its SRS generation (`srs_gen.py`) has its counterpart in
`utils/srs.py` and kernel K6."""
