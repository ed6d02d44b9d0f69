#!/bin/sh
# The one-command full test suite: one pytest process PER TEST FILE.
#
# jaxlib 0.9's XLA:CPU has crashed (SIGSEGV/SIGABRT) compiling or
# cache-loading a large executable once a single process had accumulated
# enough compiled programs.  Running each file in a fresh process keeps a
# crash in one file from taking down the rest; every file passes solo.
#
# Usage: ./run_tests.sh [extra pytest args]
status=0
for f in tests/test_*.py; do
    echo "== $f"
    if ! python -m pytest "$f" -q "$@"; then
        status=1
        echo "== $f FAILED"
    fi
done
if [ "$status" -eq 0 ]; then
    echo "ALL FILES GREEN"
else
    echo "SUITE FAILED"
fi
exit $status
