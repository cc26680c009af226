"""setup.srs_s: seconds of the benchmark's span around the program's SRS
construction (`kzg/srs.py::setup_device`), closed by a synchronize."""


def read(run):
    spans = [e - s for n, s, e in run.spans if n == "setup.srs"]
    return spans[0] if spans else None
