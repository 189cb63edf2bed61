"""Seconds from the process's start to the window's: imports, the kernel
libraries' load (and build, in a checkout's first run), the tables, the
warm round."""


def read(rec):
    return rec["setup_s"]
