"""Command-line apps of the port (counterparts of the JAX package's
`apps/`): `python -m orb_slam2_ssd_semantic_tpu_torch.apps.<name> ...`.
Each runs on the card unless given `--device cpu`. Each is split into
`main(argv)`, which parses its arguments and loads its input, and a
function that takes the frames or the data, which scripts can call on
frames they already hold."""
