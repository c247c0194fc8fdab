import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)
sys.path[:0] = [HERE, PORTBENCH, os.path.dirname(PORTBENCH)]
