from .run_davis import main

if __name__ == "__main__":
    main()
