"""Tiny sizes of every cell for the CPU tests: the same code paths at
widths a test run holds."""

# four layers at BERT's head size (D 64): the fewest at which the float8
# control parts from the bfloat16 program by the cells' own limits
ENCODER = {"num_layers": 4, "d_model": 128, "num_heads": 2, "d_ff": 512, "vocab_size": 512,
           "max_len": 128}
TINY = {
    "higgs.fit": {"config": {"rows": 20000, "num_leaves": 15, "num_iterations": 4,
                             "min_sum_hessian_in_leaf": 5.0}},
    "higgs.score": {"config": {"num_leaves": 15, "num_iterations": 5},
                    "traffic": {"rows": 3000, "sketch_rows": 5000, "check_every": 2}},
    "bert_base.score_512": {
        "config": ENCODER,
        "traffic": {"rows": 8, "tokens": 64, "mini_batch_size": 4, "check_rows": 16,
                    "check_block": 8}},
    "bert_base.score_128": {
        "config": ENCODER,
        "traffic": {"rows": 16, "tokens": 32, "mini_batch_size": 8, "check_rows": 16,
                    "check_block": 8}},
}
SEED = 2 ** 33 + 5
