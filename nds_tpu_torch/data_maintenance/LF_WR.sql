-- Copied from nds_tpu/data_maintenance/LF_WR.sql, unchanged.
-- LF_WR: refresh-insert web_returns from the returns staging table
-- (role of reference nds/data_maintenance/LF_WR.sql, original SQL).
CREATE TEMP VIEW wrv AS
SELECT d_date_sk AS wr_returned_date_sk,
       t_time_sk AS wr_returned_time_sk,
       i_item_sk AS wr_item_sk,
       c1.c_customer_sk AS wr_refunded_customer_sk,
       c1.c_current_cdemo_sk AS wr_refunded_cdemo_sk,
       c1.c_current_hdemo_sk AS wr_refunded_hdemo_sk,
       c1.c_current_addr_sk AS wr_refunded_addr_sk,
       c2.c_customer_sk AS wr_returning_customer_sk,
       c2.c_current_cdemo_sk AS wr_returning_cdemo_sk,
       c2.c_current_hdemo_sk AS wr_returning_hdemo_sk,
       c2.c_current_addr_sk AS wr_returning_addr_sk,
       wp_web_page_sk AS wr_web_page_sk,
       r_reason_sk AS wr_reason_sk,
       wret_order_id AS wr_order_number,
       wret_return_qty AS wr_return_quantity,
       wret_return_amt AS wr_return_amt,
       wret_return_tax AS wr_return_tax,
       wret_return_amt + wret_return_tax AS wr_return_amt_inc_tax,
       wret_return_fee AS wr_fee,
       wret_return_ship_cost AS wr_return_ship_cost,
       wret_refunded_cash AS wr_refunded_cash,
       wret_reversed_charge AS wr_reversed_charge,
       wret_account_credit AS wr_account_credit,
       wret_return_amt + wret_return_tax + wret_return_fee
         + wret_return_ship_cost - wret_refunded_cash
         - wret_reversed_charge - wret_account_credit AS wr_net_loss
-- join kinds mirror the reference row-for-row (LF_WR.sql: every lookup
-- LEFT OUTER — failed lookups insert with NULL surrogate keys)
FROM s_web_returns
LEFT JOIN item ON i_item_id = wret_item_id
LEFT JOIN date_dim ON d_date = CAST(wret_return_date AS DATE)
LEFT JOIN time_dim ON t_time = CAST(wret_return_time AS INT)
LEFT JOIN customer c1 ON c1.c_customer_id = wret_refund_customer_id
LEFT JOIN customer c2 ON c2.c_customer_id = wret_return_customer_id
LEFT JOIN web_page ON wp_web_page_id = wret_web_page_id
LEFT JOIN reason ON r_reason_id = wret_reason_id;
INSERT INTO web_returns SELECT * FROM wrv;
DROP VIEW wrv
