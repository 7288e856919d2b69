"""Command-line entry points of the port: `python -m
superpoint_graph_tpu_torch.cli.<partition|train|evaluate|ssp_preprocess|
ssp_train|ssp_generate|ssp_evaluate|write_semantic3d|visualize>`, with
the JAX package's flags. They run on the card (a CPU caller passes
device="cpu" to `main`), except visualize, which writes plys on the
host."""
