#!/usr/bin/env bash
set -e
cd "$(dirname "$0")"
python client.py --cf fedml_config.yaml --rank 1 &
python client.py --cf fedml_config.yaml --rank 2 &
python server.py --cf fedml_config.yaml --rank 0
wait
