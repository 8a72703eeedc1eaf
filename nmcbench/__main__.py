"""python3 -m nmcbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>"""
import time

T_START = time.perf_counter()       # set-up is timed from here

if __name__ == "__main__":
    import sys

    from nmcbench.run import main
    sys.exit(main(t_start=T_START))
