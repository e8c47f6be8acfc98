"""The benchmark of the PyTorch and CUDA port of the RGB-D SLAM system
(`orb_slam2_ssd_semantic_tpu_torch`): `python3 slambench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>` from the root
of a checkout, on a machine with the cell's CUDA cards."""
