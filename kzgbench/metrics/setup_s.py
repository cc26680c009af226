"""setup_s: seconds from the start of the process to the first timed
request (imports, the kernels' build or load, the SRS, the inputs, the
warm-up), less the reference's own seconds in set-up (spans
`reference.<stage>`: the verify cell's proofs, made as a sender would)."""


def read(run):
    return run.setup_s
