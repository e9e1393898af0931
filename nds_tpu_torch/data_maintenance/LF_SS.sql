-- Copied from nds_tpu/data_maintenance/LF_SS.sql, unchanged.
-- LF_SS: refresh-insert store_sales from the purchase staging tables.
-- Same transformation the reference's LF_SS performs (reference
-- nds/data_maintenance/LF_SS.sql: staging -> dimension joins -> INSERT),
-- written for this framework's dialect and staging schemas.
CREATE TEMP VIEW ssv AS
SELECT d_date_sk AS ss_sold_date_sk,
       t_time_sk AS ss_sold_time_sk,
       i_item_sk AS ss_item_sk,
       c_customer_sk AS ss_customer_sk,
       c_current_cdemo_sk AS ss_cdemo_sk,
       c_current_hdemo_sk AS ss_hdemo_sk,
       c_current_addr_sk AS ss_addr_sk,
       s_store_sk AS ss_store_sk,
       p_promo_sk AS ss_promo_sk,
       purc_purchase_id AS ss_ticket_number,
       plin_quantity AS ss_quantity,
       i_wholesale_cost AS ss_wholesale_cost,
       i_current_price AS ss_list_price,
       plin_sale_price AS ss_sales_price,
       (i_current_price - plin_sale_price) * plin_quantity AS ss_ext_discount_amt,
       plin_sale_price * plin_quantity AS ss_ext_sales_price,
       i_wholesale_cost * plin_quantity AS ss_ext_wholesale_cost,
       i_current_price * plin_quantity AS ss_ext_list_price,
       ROUND(plin_sale_price * plin_quantity * 0.08, 2) AS ss_ext_tax,
       plin_coupon_amt AS ss_coupon_amt,
       plin_sale_price * plin_quantity - plin_coupon_amt AS ss_net_paid,
       ROUND((plin_sale_price * plin_quantity - plin_coupon_amt) * 1.08, 2) AS ss_net_paid_inc_tax,
       plin_sale_price * plin_quantity - plin_coupon_amt
         - i_wholesale_cost * plin_quantity AS ss_net_profit
-- join kinds mirror the reference row-for-row (LF_SS.sql: every dimension
-- lookup LEFT OUTER so failed lookups still insert with NULL surrogate
-- keys; only the order->lineitem join is INNER)
FROM s_purchase
JOIN s_purchase_lineitem ON purc_purchase_id = plin_purchase_id
LEFT JOIN item ON i_item_id = plin_item_id
LEFT JOIN date_dim ON d_date = CAST(purc_purchase_date AS DATE)
LEFT JOIN time_dim ON t_time = purc_purchase_time
LEFT JOIN customer ON c_customer_id = purc_customer_id
LEFT JOIN store ON s_store_id = purc_store_id
LEFT JOIN promotion ON p_promo_id = plin_promotion_id;
INSERT INTO store_sales SELECT * FROM ssv;
DROP VIEW ssv
