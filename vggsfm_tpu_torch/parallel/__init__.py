"""Multi-host pieces of the port: the file-exchange map merge of the
video pipeline (parallel/merge.py)."""
