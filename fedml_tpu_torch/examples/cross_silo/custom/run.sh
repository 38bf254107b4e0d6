#!/usr/bin/env bash
# 1 server + 2 silo clients as separate OS processes over gRPC —
# the reference's localhost multi-process pattern (SURVEY.md §4).
set -e
cd "$(dirname "$0")"
python client.py --cf fedml_config.yaml --rank 1 &
python client.py --cf fedml_config.yaml --rank 2 &
python server.py --cf fedml_config.yaml --rank 0
wait
