"""The supervised partition, SSP (Landrieu & Boussaha, CVPR 2019): a
per-point PointNet embedder trained with graph-structured contrastive
losses, with cut pursuit on the embeddings inside every training step.
Port of superpoint_graph_tpu/ssp/."""
